"""Tests of the port that need an NVIDIA GPU (marked ``cuda``; they skip
where ``torch.cuda.is_available()`` is false). This file imports no JAX, so
it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return build_demo_scene(texture_resolution=8, sphere_detail=6,
                            device="cpu")


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-2.5, 2.5, (3, n)).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o4 = torch.from_numpy(np.concatenate([o, np.ones((1, n), np.float32)]))
    d4 = torch.from_numpy(np.concatenate([d, np.zeros((1, n), np.float32)]))
    return o4, d4


def _args(scene, n, device):
    prep = ti.prepare_trace_inputs(scene.to(device))
    o4, d4 = _rays(n, 0)
    return (o4.to(device), d4.to(device), prep.bounds, prep.mu, prep.mv,
            prep.mw, prep.tab)


def _shadow_args(scene, n, device):
    """Kernel 2's operands: random shadow rays with limits in (0, 4), a
    quarter of them parked (limit 0)."""
    prep = ti.prepare_trace_inputs(scene.to(device))
    o4, d4 = _rays(n, 1)
    g = np.random.default_rng(2)
    tlim = g.uniform(0.0, 4.0, n).astype(np.float32)
    tlim[g.uniform(size=n) < 0.25] = 0.0
    return tuple(x.to(device) for x in (o4, d4, torch.from_numpy(tlim))) \
        + (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw)


@pytest.mark.parametrize("n", [256, 4096])
def test_kernel_matches_plain(scene, n):
    args = _args(scene, n, "cuda")
    before = ti.closest_hit_rows.launches
    got = ti.closest_hit_rows(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_rows.launches == before + 1
    want = ti.closest_hit_rows_plain(*args)
    # Built with -fmad=false: every row equal, t bit for bit.
    assert torch.equal(got, want)
    assert torch.equal(got[40].view(torch.int32), want[40].view(torch.int32))
    assert (got[40] < ti._MISS).any()


def test_kernel_matches_cpu_plain(scene):
    """Same inputs (built on the CPU, copied to the card): the kernel's
    rows equal the CPU plain version's."""
    args = _args(scene, 512, "cpu")
    got = ti.closest_hit_rows(*(a.cuda() for a in args)).cpu()
    assert torch.equal(got, ti.closest_hit_rows(*args))


@pytest.mark.parametrize("n", [256, 4096])
def test_occlusion_kernel_matches_plain(scene, n):
    args = _shadow_args(scene, n, "cuda")
    before = ti.occluded.launches
    got = ti.occluded(*args)
    torch.cuda.synchronize()
    assert ti.occluded.launches == before + 1
    want = ti.occluded_plain(*args).occ
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < n  # both answers occur


@pytest.mark.parametrize("n", [256, 4096])
def test_fused_kernel_matches_plain(scene, n):
    a = _args(scene, n, "cuda")
    s = _shadow_args(scene, n, "cuda")
    args = a[:2] + s[:3] + s[3:5] + a[3:6] + a[6:]
    before = ti.closest_hit_rows_nee.launches
    rows, occ = ti.closest_hit_rows_nee(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_rows_nee.launches == before + 1
    rows_p, occ_p = ti.closest_hit_rows_nee_plain(*args)
    assert torch.equal(rows, rows_p) and torch.equal(occ, occ_p)
    # ... which are kernels 1 and 2 run apart.
    assert torch.equal(rows[:47], ti.closest_hit_rows(*a)[:47])
    assert torch.equal(occ, ti.occluded(*s))


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_render_cuda_matches_cpu(scene, nee):
    """The standard loop on the card against the CPU; with NEE the shadow
    queries ride kernel 4 and the trailing kernel-2 flush."""
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen=False, bounces=4,
                       nee=nee)
    cam = demo_camera(40, 24)
    a = render_radiance(scene.to("cuda"), cam, cfg, 3)
    b = render_radiance(scene, cam, cfg, 3)
    ok = (torch.abs(a.radiance.cpu() - b.radiance) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= 0.99
    assert torch.equal(a.segments.cpu()[ok], b.segments[ok])


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_regen_cuda_matches_cpu(scene, nee):
    """The default loop (regen) on the card against the CPU at 64x48: the
    card's sqrt and division round differently, so within the image
    tolerance, not bit for bit."""
    cfg = RenderConfig(traversal=Traversal.PALLAS, nee=nee)
    cam = demo_camera(64, 48)
    a = render_radiance(scene.to("cuda"), cam, cfg, 3)
    b = render_radiance(scene, cam, cfg, 3)
    ok = (torch.abs(a.radiance.cpu() - b.radiance) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= 0.99
    assert torch.equal(a.segments.cpu()[ok], b.segments[ok])


@pytest.fixture(scope="module")
def grid():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from gdpathtracing_torch.scene.demo import build_sphere_grid
    return ti.prepare_trace_inputs(build_sphere_grid(n=4, sphere_detail=12,
                                                     device="cuda"))


def _sc_rays(n):
    """Random rays over the mid-size sphere grid, a tenth of them parked."""
    g = np.random.default_rng(4)
    o = np.stack([g.uniform(-6, 6, n), g.uniform(-0.5, 7.5, n),
                  g.uniform(-6, 6, n)]).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    park = g.uniform(size=n) < 0.1
    o[:, park], d[:, park] = 1e9, 0.5773503
    o4 = np.concatenate([o, np.ones((1, n), np.float32)])
    d4 = np.concatenate([d, np.zeros((1, n), np.float32)])
    return torch.from_numpy(o4).cuda(), torch.from_numpy(d4).cuda()


@pytest.mark.parametrize("n", [256, 4096])
def test_sc_lite_kernel_matches_plain(grid, n):
    args = _sc_rays(n) + (grid.sc_bounds, grid.chunk_bounds,
                          grid.group_bounds, grid.mu_pad, grid.mv_pad,
                          grid.mw_pad, grid.scc)
    before = ti.closest_hit_sc_lite.launches
    got = ti.closest_hit_sc_lite(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_sc_lite.launches == before + 1
    want = ti.closest_hit_sc_lite_plain(*args)
    assert torch.equal(got, want)
    assert (got[0] < ti._MISS).any()


@pytest.mark.parametrize("n", [256, 4096])
def test_rows_sc_kernel_matches_plain(grid, n):
    args = _sc_rays(n) + (grid.sc_bounds, grid.chunk_bounds, grid.mu_pad,
                          grid.mv_pad, grid.mw_pad, grid.tab, grid.scc)
    before = ti.closest_hit_rows_sc.launches
    got = ti.closest_hit_rows_sc(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_rows_sc.launches == before + 1
    assert torch.equal(got, ti.closest_hit_rows_sc_plain(*args))
    # The lite kernel's winners, steps and superchunk entries (kernel 6
    # takes no group boxes; kernel 3 does).
    lite = ti.closest_hit_sc_lite(*args[:4], grid.group_bounds, *args[4:7],
                                  args[8])
    assert torch.equal(lite[:4], got[[40, 44, 45, 46]])


@pytest.fixture(scope="module")
def bench_grid():
    """The bench's sphere grid (n=10: 96256 triangles, 376 chunks in 47
    superchunks of 8), kernel 3's scene in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from gdpathtracing_torch.scene.demo import build_sphere_grid
    return ti.prepare_trace_inputs(build_sphere_grid(n=10, sphere_detail=16,
                                                     device="cuda"))


# (source eidx, destination eidx) of the triangles copied for exact ties on
# the bench grid: within chunk 3 (group 0 into group 6), from chunk 3 into
# chunk 100 (another superchunk), from chunk 300 into chunk 50 (before its
# source), within chunk 7 (group 7 into group 0, before its source).
GRID_COPIES = ((3 * 256 + 17, 3 * 256 + 200), (3 * 256 + 40, 100 * 256 + 5),
               (300 * 256 + 100, 50 * 256 + 250),
               (7 * 256 + 230, 7 * 256 + 12))


def _aim_at(rows, eidx, dist, g):
    """(3, n) origins and directions of rays at points inside triangles
    ``eidx`` (n,) (barycentric u, v drawn in [0.2, 0.4]) from ``dist`` off
    their planes along the normal, ``rows`` the numpy (mu, mv, mw)."""
    mu, mv, mw = (x[:, eidx].astype(np.float64) for x in rows)
    a = np.stack([mu[:3].T, mv[:3].T, mw[:3].T], axis=1)
    u, v = g.uniform(0.2, 0.4, (2, eidx.size))
    p = np.linalg.solve(a, np.stack([u - mu[3], v - mv[3], -mw[3]],
                                    axis=1)[..., None])[..., 0].T
    nrm = mw[:3] / np.linalg.norm(mw[:3], axis=0)
    return p + dist * nrm, -nrm


def _well_formed(rows):
    """(E,) bool: triangles whose (mu, mv, mw) frame is invertible (not a
    pad column)."""
    a = np.stack([x[:3].T for x in rows], axis=1).astype(np.float64)
    return np.abs(np.linalg.det(a)) > 1e-9


def _two_level_set(prep, kind, n):
    """Operands of kernels 3 and 6 (rays on the card, kernel 6's geometry,
    the winner table, each ray's aimed eidx or -1, kernel 3's group boxes)
    for an adversarial ray set on ``prep`` (the bench grid), from a numpy
    seed:
    - one_per_block: one random ray in each 256-ray block, the rest parked
      (origin 1e9): k = 1 on every chunk a block stages;
    - same_chunk: the 256 rays of a block aimed at one triangle of a
      sphere's upper half from 0.25 off its plane: k = 256 on that chunk,
      where the rays' own threads sweep;
    - edges: rays at triangle 255 of a chunk and at triangle 0 of the next
      from 1e-2 off (the winner at either end of a chunk), a tenth parked;
    - ties: rays at the triangles of GRID_COPIES, copied into the
      destination columns (chunk, superchunk and group boxes grown to hold
      them), random rays and a tenth parked: two triangles at the same t,
      the lower eidx wins;
    - random: random rays over the grid, a tenth parked."""
    g = np.random.default_rng({"one_per_block": 21, "same_chunk": 22,
                               "edges": 23, "ties": 24, "random": 25}[kind])
    rows = [x.cpu().numpy().copy() for x in (prep.mu_pad, prep.mv_pad,
                                            prep.mw_pad)]
    cb = prep.chunk_bounds.cpu().numpy().copy()
    sb = prep.sc_bounds.cpu().numpy().copy()
    gb = prep.group_bounds.cpu().numpy().copy()
    ok = _well_formed(rows)
    aimed = np.full(n, -1)
    o = np.stack([g.uniform(-14, 14, n), g.uniform(-0.5, 3.0, n),
                  g.uniform(-14, 14, n)])
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    park = g.uniform(size=n) < 0.1
    if kind == "one_per_block":
        park = np.ones(n, bool)
        park[np.arange(0, n, ti.BN) + g.integers(0, ti.BN, n // ti.BN)] = False
    elif kind == "same_chunk":
        # Centroids 0.2-0.9 above the sphere centres' plane: off the floor
        # and the light, and 0.25 off them nothing lies between.
        mu, mv, mw = (x[:, ok].astype(np.float64) for x in rows)
        a = np.stack([mu[:3].T, mv[:3].T, mw[:3].T], axis=1)
        cy = np.linalg.solve(a, np.stack([1 / 3 - mu[3], 1 / 3 - mv[3],
                                          -mw[3]], axis=1)[..., None])[:, 1, 0]
        tri = g.choice(np.flatnonzero(ok)[(cy > 0.2) & (cy < 0.9)],
                       n // ti.BN)
        aimed = np.repeat(tri, ti.BN)
        o, d = _aim_at(rows, aimed, 0.25, g)
        park[:] = False
    elif kind == "edges":
        c = g.choice(np.flatnonzero(ok[255:-1:ti.BT] & ok[256::ti.BT]), n)
        aimed = c * ti.BT + np.where(g.uniform(size=n) < 0.5, 255, 256)
        o, d = _aim_at(rows, aimed, 1e-2, g)
    elif kind == "ties":
        for src, dst in GRID_COPIES:
            assert ok[src]
            for x in rows:
                x[:, dst] = x[:, src]
            for boxes, col, box in (
                    (cb, dst // ti.BT, cb[:, src // ti.BT]),
                    (sb, dst // ti.BT // prep.scc, cb[:, src // ti.BT]),
                    (gb, dst // ti.GW, gb[:, src // ti.GW].copy())):
                boxes[0:3, col] = np.minimum(boxes[0:3, col], box[0:3])
                boxes[3:6, col] = np.maximum(boxes[3:6, col], box[3:6])
        pick = g.uniform(size=n) < 0.6
        aimed[pick] = np.array([min(s, t) for s, t in GRID_COPIES])[
            g.integers(0, len(GRID_COPIES), int(pick.sum()))]
        o[:, pick], d[:, pick] = _aim_at(rows, aimed[pick], 1e-2, g)
        park &= ~pick
    o[:, park], d[:, park] = 1e9, 0.5773503
    aimed[park] = -1
    o4 = np.concatenate([o, np.ones((1, n))]).astype(np.float32)
    d4 = np.concatenate([d, np.zeros((1, n))]).astype(np.float32)
    dev = prep.mu_pad.device
    geo = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (sb, cb, *rows))
    rays = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (o4, d4))
    tab = prep.tab
    if kind == "ties":  # the copies' table columns too
        tab = tab.clone()
        for src, dst in GRID_COPIES:
            tab[:, dst] = tab[:, src]
    return rays, geo, tab, aimed, torch.from_numpy(gb).to(dev)


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["one_per_block", "same_chunk", "edges",
                                  "ties"])
@pytest.mark.parametrize("kernel", ["lite", "rows"])
def test_two_level_kernels_adversarial(bench_grid, kernel, kind, n):
    """Kernels 3 and 6 (the block-cooperative walk) against their plain
    versions bit for bit in every row, on the adversarial sets of
    _two_level_set; the aimed rays find the triangle they were aimed at
    (for ties: the lower eidx of the two)."""
    rays, geo, tab, aimed, gb = _two_level_set(bench_grid, kind, n)
    if kernel == "lite":
        fn, plain = ti.closest_hit_sc_lite, ti.closest_hit_sc_lite_plain
        args = rays + geo[:2] + (gb,) + geo[2:] + (bench_grid.scc,)
        t_row, e_row = 0, 1
    else:
        fn, plain = ti.closest_hit_rows_sc, ti.closest_hit_rows_sc_plain
        args = rays + geo + (tab, bench_grid.scc)
        t_row, e_row = 40, 44
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    on = torch.from_numpy(aimed >= 0).cuda()
    if kind == "one_per_block":
        assert int((rays[0][0] < 1e8).sum()) == n // ti.BN
    else:
        assert torch.equal(got[e_row][on].long(),
                           torch.from_numpy(aimed).cuda()[on])
    assert (got[t_row] < ti._MISS).any()


@pytest.fixture(scope="module")
def bench_grid_frame():
    """The bench grid's rays where kernel 3's group gate culls most: the
    1080p frame's middle 262144-ray tile of camera rays and one BRDF
    bounce from their hits (ops/tiles.py, chip_smoke.py phase 2's tiles),
    with the grid's trace inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from gdpathtracing_torch.ops import tiles as kt
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    scene = build_sphere_grid(n=10, sphere_detail=16, device="cuda")
    prep = ti.prepare_trace_inputs(scene)
    cfg = RenderConfig(traversal=Traversal.PALLAS)
    primary, hit, s, seed = kt.middle_rays(
        scene, grid_camera(kt.W, kt.H, n=10), prep, cfg, cfg.tile_rays,
        kt.middle_tile(cfg))
    bounce, active = kt.bounce_rays(s, hit, seed, cfg)
    return prep, {"primary": ti.pack_rays(primary, None),
                  "bounce 1": ti.pack_rays(bounce, active)}


@pytest.mark.parametrize("rays", ["primary", "bounce 1"])
def test_sc_lite_kernel_on_grid_frame_rays(bench_grid_frame, rays):
    """Kernel 3 against its plain version bit for bit in all 8 rows on the
    bench grid's camera and bounce-1 rays, where its group gate skips most
    of the chunk sweeps' tests (the plain version ignores the group
    boxes)."""
    prep, tiles = bench_grid_frame
    geo = (prep.sc_bounds, prep.chunk_bounds, prep.group_bounds,
           prep.mu_pad, prep.mv_pad, prep.mw_pad, prep.scc)
    got = ti.closest_hit_sc_lite(*tiles[rays], *geo)
    torch.cuda.synchronize()
    want = ti.closest_hit_sc_lite_plain(*tiles[rays], *geo)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((got[0] < ti._MISS).sum()) > got.shape[1] // 10
    work = ti.walk_two_level_plain(*tiles[rays], *geo[:2], *geo[3:],
                                   group_bounds=prep.group_bounds)
    kept = float(work.group_sweeps.sum()) * ti.GW / float(got[2].sum())
    assert 0.0 < kept < 0.5


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["one_per_block", "same_chunk", "edges",
                                  "ties"])
def test_flat_rows_kernel_adversarial(bench_grid, kind, n):
    """Kernel 1 (the block-cooperative flat walk) on the adversarial sets of
    _two_level_set, the bench grid's 384 padded chunks walked flat: all 48
    rows bit for bit against the plain version, the counters 45 (tests a
    ray needed) and 46 (chunks its block swept) included; the aimed rays
    find the triangle they were aimed at (for ties: the lower eidx)."""
    rays, geo, tab, aimed, _ = _two_level_set(bench_grid, kind, n)
    args = rays + geo[1:] + (tab,)
    before = ti.closest_hit_rows.launches
    got = ti.closest_hit_rows(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_rows.launches == before + 1
    want = ti.closest_hit_rows_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    on = torch.from_numpy(aimed >= 0).cuda()
    if kind == "one_per_block":
        assert int((rays[0][0] < 1e8).sum()) == n // ti.BN
    else:
        assert torch.equal(got[44][on].long(),
                           torch.from_numpy(aimed).cuda()[on])
    assert (got[40] < ti._MISS).any()


@pytest.fixture(scope="module")
def mid_fused():
    """The mid-size sphere grid (34 chunks, FUSED's flat walk) on the card
    with FUSED's winner table and material rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from gdpathtracing_torch.ops import fused as fu
    from gdpathtracing_torch.scene.demo import build_sphere_grid
    s = build_sphere_grid(n=4, sphere_detail=12, device="cuda")
    return ti.prepare_trace_inputs(s), fu._build_table(s), fu._build_mats(s)


# (source eidx, destination eidx) of the triangles copied for exact ties on
# the mid grid: within chunk 3, from chunk 3 into chunk 20, from chunk 30
# into chunk 9 (before its source).
MID_COPIES = ((3 * 256 + 17, 3 * 256 + 200), (3 * 256 + 40, 20 * 256 + 5),
              (30 * 256 + 100, 9 * 256 + 250))


def _fused_set(mid_fused, kind, n):
    """Kernel 11's operands (camera paths on the card, the mid grid's flat
    geometry, table and materials) for an adversarial set, from a numpy
    seed, and each path's first aimed distance (or -1). Random paths start
    over the grid (a tenth parked, origin 1e9):
    - one_per_block: one random path in each 256-ray block, the rest
      parked: k <= 1 on every chunk a block stages, at every bounce;
    - same_chunk: the 256 paths of a block aimed at one triangle of a
      sphere's upper half from 0.25 off its plane: k = 256 on that chunk at
      bounce 0, where the rays' own threads sweep;
    - edges: paths at triangle 255 of a chunk and at triangle 0 of the
      next from 1e-2 off (the winner at either end of a chunk);
    - ties: paths at the triangles of MID_COPIES, copied with their table
      rows into the destination columns (boxes grown to hold them), the
      copies given the next material, so the lower eidx's material shows
      in the radiance;
    - die: every path leaves the scene upward from above the light (or is
      parked), so all die after bounce 0 and every block walks bounces
      1-4 with no live path;
    - one_live: random paths, but in every other block all but one leave
      the scene at bounce 0: a block with one live path."""
    prep, table, mats = mid_fused
    g = np.random.default_rng({"one_per_block": 41, "same_chunk": 42,
                               "edges": 43, "ties": 44, "die": 45,
                               "one_live": 46}[kind])
    rows = [x.cpu().numpy().copy() for x in (prep.mu, prep.mv, prep.mw)]
    cb = prep.bounds.cpu().numpy().copy()
    table = table.clone()
    ok = _well_formed(rows)
    aimed = np.full(n, -1.0)
    o = np.stack([g.uniform(-6, 6, n), g.uniform(-0.5, 7.5, n),
                  g.uniform(-6, 6, n)])
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    park = g.uniform(size=n) < 0.1
    up = np.zeros(n, bool)  # paths that leave the scene upward
    if kind == "one_per_block":
        park = np.ones(n, bool)
        park[np.arange(0, n, ti.BN) + g.integers(0, ti.BN, n // ti.BN)] = False
    elif kind == "same_chunk":
        mu, mv, mw = (x[:, ok].astype(np.float64) for x in rows)
        a = np.stack([mu[:3].T, mv[:3].T, mw[:3].T], axis=1)
        cy = np.linalg.solve(a, np.stack([1 / 3 - mu[3], 1 / 3 - mv[3],
                                          -mw[3]], axis=1)[..., None])[:, 1, 0]
        tri = g.choice(np.flatnonzero(ok)[(cy > 0.2) & (cy < 0.9)],
                       n // ti.BN)
        o, d = _aim_at(rows, np.repeat(tri, ti.BN), 0.25, g)
        aimed[:] = 0.25
        park[:] = False
    elif kind == "edges":
        c = g.choice(np.flatnonzero(ok[255:-1:ti.BT] & ok[256::ti.BT]), n)
        tri = c * ti.BT + np.where(g.uniform(size=n) < 0.5, 255, 256)
        o, d = _aim_at(rows, tri, 1e-2, g)
        aimed[:] = 1e-2
    elif kind == "ties":
        for src, dst in MID_COPIES:
            assert ok[src]
            for x in rows:
                x[:, dst] = x[:, src]
            table[dst] = table[src]
            table[dst, 27] = (table[src, 27] + 1) % mats.shape[0]
            cb[0:3, dst // ti.BT] = np.minimum(cb[0:3, dst // ti.BT],
                                               cb[0:3, src // ti.BT])
            cb[3:6, dst // ti.BT] = np.maximum(cb[3:6, dst // ti.BT],
                                               cb[3:6, src // ti.BT])
        pick = g.uniform(size=n) < 0.6
        tri = np.array([min(s, t) for s, t in MID_COPIES])[
            g.integers(0, len(MID_COPIES), int(pick.sum()))]
        o[:, pick], d[:, pick] = _aim_at(rows, tri, 1e-2, g)
        aimed[pick] = 1e-2
        park &= ~pick
    elif kind == "die":
        up[:] = True
    elif kind == "one_live":
        up = (np.arange(n) // ti.BN) % 2 == 0
        up[np.arange(0, n, 2 * ti.BN) + g.integers(0, ti.BN, -(-n // (
            2 * ti.BN)))] = False
    o[:, up] = np.stack([g.uniform(-6, 6, int(up.sum())),
                         np.full(int(up.sum()), 20.0),
                         g.uniform(-6, 6, int(up.sum()))])
    d[1, up] = np.abs(d[1, up]) + 0.1
    d[:, up] /= np.linalg.norm(d[:, up], axis=0, keepdims=True)
    o[:, park], d[:, park] = 1e9, 0.5773503
    aimed[park] = -1
    dev = prep.mu.device
    o4, d4 = (torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [x, np.full((1, n), w)]), dtype=np.float32)).to(dev)
        for x, w in ((o, 1.0), (d, 0.0)))
    seeds = torch.from_numpy(g.integers(-2**31, 2**31, (2, n),
                                        dtype=np.int32)).to(dev)
    geo = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (cb, *rows))
    return (o4, d4, seeds, *geo, table, mats), aimed, up


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["one_per_block", "same_chunk", "edges",
                                  "ties", "die", "one_live"])
def test_fused_paths_kernel_adversarial(mid_fused, kind, n):
    """Kernel 11 (5 bounces, each on the block-cooperative flat walk) on the
    adversarial sets of _fused_set: radiance, depth, normal and segments
    bit for bit against the plain version; the aimed paths' depth is their
    distance to the aimed triangle, and the paths that leave the scene
    trace one segment."""
    from gdpathtracing_torch.ops import fused as fu
    args, aimed, up = _fused_set(mid_fused, kind, n)
    cfg = RenderConfig(traversal=Traversal.FUSED)
    before = fu.fused_paths.launches
    got = fu.fused_paths(*args, cfg)
    torch.cuda.synchronize()
    assert fu.fused_paths.launches == before + 1
    want = fu.fused_paths_plain(*args, cfg)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    on = aimed >= 0
    depth = got[0][3].cpu().numpy()
    np.testing.assert_allclose(depth[on], aimed[on], rtol=1e-3)
    segs = got[1].cpu().numpy()
    assert (segs[up] == 1).all() and (depth[up] == ti._MISS).all()
    if kind == "die":
        assert (segs == 1).all()
    elif kind in ("same_chunk", "edges", "ties"):
        assert (segs > 1).any()


def _padded_halves(prep, cb, copies=()):
    """(8, 2 nc_pad) half boxes for ``prep``'s padded chunks: the flat
    half boxes, a point box at 1e30 for each half of a pad chunk (as the
    pad chunks' boxes), and for each (src, dst) of ``copies`` the half of
    dst grown to hold the half of src (the copied triangle)."""
    sub = prep.sub_bounds.cpu().numpy()
    pad = np.repeat(cb[:, sub.shape[1] // ti.SUB:], ti.SUB, axis=1)
    sub = np.concatenate([sub, pad], axis=1)
    for src, dst in copies:
        hs, hd = src // ti.SW, dst // ti.SW
        sub[0:3, hd] = np.minimum(sub[0:3, hd], sub[0:3, hs])
        sub[3:6, hd] = np.maximum(sub[3:6, hd], sub[3:6, hs])
    return np.ascontiguousarray(sub)


def _box_distance(p, lo, hi):
    """(n,) Euclidean distance from points ``p`` (3, n) to boxes
    [``lo``, ``hi``] (3, n); 0 inside."""
    gap = np.maximum(np.maximum(lo - p, p - hi), 0.0)
    return np.sqrt((gap * gap).sum(axis=0))


def _nee_shadow_set(rows, cb, sub, kind, n, g):
    """Kernel 4's shadow rays (numpy (4, n) o4, d4 and (n,) limits) for an
    adversarial set on the padded chunks ``cb`` with half boxes ``sub``
    and rows ``rows``:
    - parked: every shadow ray parked (origin 1e9, limit 0);
    - miss_halves: each ray starts inside a chunk's box but more than 0.05
      from both its halves' boxes, with a limit of 0.02: it passes the
      chunk's gate (kernel 4's row 47 counts the chunk) and neither
      half's, so it tests nothing there, and where no other ray of its
      block needs that chunk (about a tenth of the block's candidates)
      the candidate lists no ray;
    - occluded_early: the 256 rays of a block aimed at one triangle from
      0.25 off its plane, through it, with a limit of 20: the chunk of the
      first blocker resolves the whole block, and the later chunks its
      rays' gates passed at the group vote are candidates with no
      unresolved ray."""
    if kind == "parked":
        o = np.full((3, n), 1e9)
        d = np.full((3, n), 0.5773503)
        lim = np.zeros(n)
    elif kind == "miss_halves":
        real = np.flatnonzero(cb[0] < 1e29)
        pool_o, pool_c = [], []
        while sum(x.size for x in pool_c) < n:
            c = g.choice(real, 4 * n)
            p = g.uniform(cb[0:3, c], cb[3:6, c])
            far = np.minimum(
                _box_distance(p, sub[0:3, 2 * c], sub[3:6, 2 * c]),
                _box_distance(p, sub[0:3, 2 * c + 1], sub[3:6, 2 * c + 1]))
            pool_o.append(p[:, far > 0.05])
            pool_c.append(c[far > 0.05])
        o = np.concatenate(pool_o, axis=1)[:, :n]
        d = g.normal(size=(3, n))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        lim = np.full(n, 0.02)
    else:
        ok = _well_formed(rows)
        tri = np.repeat(g.choice(np.flatnonzero(ok), n // ti.BN), ti.BN)
        o, d = _aim_at(rows, tri, 0.25, g)
        lim = np.full(n, 20.0)
    return tuple(np.ascontiguousarray(x, dtype=np.float32) for x in (
        np.concatenate([o, np.ones((1, n))]),
        np.concatenate([d, np.zeros((1, n))]), lim))


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("shadow", ["parked", "miss_halves",
                                    "occluded_early"])
@pytest.mark.parametrize("kind", ["one_per_block", "same_chunk", "edges",
                                  "ties"])
def test_rows_nee_kernel_adversarial(bench_grid, kind, shadow, n):
    """Kernel 4 (the flat closest-hit walk, then the any-hit walk, one
    launch) on the bench grid's 384 padded chunks walked flat: the bounce
    rays of _two_level_set's adversarial sets with the shadow rays of
    _nee_shadow_set. All 48 rows bit for bit against the plain version,
    the counters 45-47 included, and the occlusion flags equal; the aimed
    bounce rays find their triangle."""
    rays, geo, tab, aimed, _ = _two_level_set(bench_grid, kind, n)
    cb = geo[1].cpu().numpy()
    rows = [x.cpu().numpy() for x in geo[2:]]
    sub = _padded_halves(bench_grid, cb,
                         GRID_COPIES if kind == "ties" else ())
    g = np.random.default_rng({"parked": 51, "miss_halves": 52,
                               "occluded_early": 53}[shadow])
    dev = rays[0].device
    so4, sd4, lim = (torch.from_numpy(x).to(dev)
                     for x in _nee_shadow_set(rows, cb, sub, shadow, n, g))
    args = (*rays, so4, sd4, lim, geo[1], torch.from_numpy(sub).to(dev),
            *geo[2:], tab)
    before = ti.closest_hit_rows_nee.launches
    got, occ = ti.closest_hit_rows_nee(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_rows_nee.launches == before + 1
    want, occ_p = ti.closest_hit_rows_nee_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(occ, occ_p)
    on = torch.from_numpy(aimed >= 0).cuda()
    if kind != "one_per_block":
        assert torch.equal(got[44][on].long(),
                           torch.from_numpy(aimed).cuda()[on])
    if shadow == "parked":
        assert not bool(occ.any()) and not bool(got[47].any())
    elif shadow == "miss_halves":
        assert bool((got[47] > 0).all())  # every block enters a chunk
    else:
        assert bool(occ.all())


@pytest.fixture(scope="module")
def mega_demo():
    """The demo scene on the card, kernel 10's operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene(device="cuda")
    return ti.prepare_trace_inputs(scene)


def _mega_set(kind, n, dev):
    """Kernel 10's packed path state (camera rays replaced by random ones
    over the demo room, random PCG2D words) for an adversarial set:
    - one_live: one live path in each 256-ray block, the rest dead
      (active 0);
    - die: every path starts above the room heading up, so all miss at
      bounce 0 and die: at bounce 1 every block is dead;
    - every_other: random paths, but in every other block all but one
      leave the room upward at bounce 0: from bounce 1 on those blocks
      hold one live path."""
    from gdpathtracing_torch.ops import megakernel as mk
    from gdpathtracing_torch.core.vec import Vec3
    from gdpathtracing_torch.render.types import Ray
    g = np.random.default_rng({"one_live": 61, "die": 62,
                               "every_other": 63}[kind])
    o = g.uniform(-2.5, 2.5, (3, n))
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    up = np.zeros(n, bool)
    if kind == "die":
        up[:] = True
    elif kind == "every_other":
        up = (np.arange(n) // ti.BN) % 2 == 0
        up[np.arange(0, n, 2 * ti.BN) + g.integers(0, ti.BN, -(-n // (
            2 * ti.BN)))] = False
    o[1, up] = 20.0
    d[1, up] = np.abs(d[1, up]) + 0.1
    d[:, up] /= np.linalg.norm(d[:, up], axis=0, keepdims=True)
    ray = Ray(*(Vec3(*(torch.from_numpy(x.astype(np.float32)).to(dev)
                       for x in v)) for v in (o, d)))
    seed = tuple(torch.from_numpy(x).to(dev) for x in g.integers(
        0, 2**32, (2, n), dtype=np.int64))
    fs, is_ = mk.pack_state(ray, seed)
    if kind == "one_live":
        live = np.zeros(n, bool)
        live[np.arange(0, n, ti.BN) + g.integers(0, ti.BN, n // ti.BN)] = True
        fs[12] = torch.from_numpy(live.astype(np.float32)).to(dev)
    return fs, is_


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["one_live", "die", "every_other"])
@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_mega_step_kernel_adversarial(mega_demo, nee, kind, n):
    """Kernel 10 (the closest-hit walk, with NEE the any-hit walk, and the
    epilogues) at bounces 0 and 1 on the adversarial states of _mega_set:
    the whole state bit for bit against the plain version, bounce 1 from
    the plain version's bounce 0."""
    from gdpathtracing_torch.ops import megakernel as mk
    prep = mega_demo
    cfg = RenderConfig(traversal=Traversal.MEGA, nee=nee)
    lt = mk._build_light_block(prep.lights if nee else None, "cuda")
    geo = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw, prep.tab,
           lt)
    state = _mega_set(kind, n, "cuda")
    for b in (0, 1):
        before = mk.mega_step.launches
        got = mk.mega_step(*state, *geo, b, cfg)
        torch.cuda.synchronize()
        assert mk.mega_step.launches == before + 1
        want = mk.mega_step_plain(*state, *geo, b, cfg)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        state = want
    live = state[0][12] > 0
    if kind == "die":
        assert not bool(live.any())
    elif kind == "every_other":
        per_block = live.view(-1, ti.BN).sum(dim=1)
        assert bool((per_block[::2] <= 1).all())


def _no_winner(n, dev):
    return torch.stack([torch.full((n,), ti._MISS, device=dev),
                        torch.full((n,), float(ti.BIG_E), device=dev)])


def _march_queue(sc_bounds, o4, d4, ql):
    """Each block's ``ql`` queue slots from the march's own candidate scan
    (k = 6) over the superchunk boxes ``sc_bounds``, from the spawn state:
    sentinels and repeats among them."""
    from types import SimpleNamespace

    from gdpathtracing_torch.core.vec import Vec3
    n, dev = o4.shape[1], o4.device
    _, ss = ti.march_next_candidates(
        SimpleNamespace(sc_bounds=sc_bounds), Vec3(*o4[:3]), Vec3(*d4[:3]),
        o4[0] < 1e8, torch.full((n,), -torch.inf, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev),
        torch.full((n,), ti._MISS, device=dev), k=6)
    return ti.march_block_queue(ss, sc_bounds.shape[1], ql)[0]


def _block_queue(nb, entries, ql, dev):
    """The same ``entries`` in every block's ``ql`` slots, sentinels after
    them (int32, (nb * ql,))."""
    q = list(entries) + [1 << 20] * (ql - len(entries))
    return torch.tensor(q, dtype=torch.int32, device=dev).repeat(nb)


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("case", ["one_per_block", "same_chunk", "edges",
                                  "tie", "repeat", "sentinels", "ql1",
                                  "ql16"])
def test_march_step_kernel_adversarial(bench_grid, case, n):
    """Kernel 7 (kernel 3's walk_superchunk_coop, entry by entry) against
    its plain version bit for bit in every row, on adversarial rounds of
    the bench grid:
    - one_per_block, same_chunk, edges: _two_level_set's rays (one needing
      ray a block; a block's 256 rays on one chunk; winners at triangle
      255 / 0 of a chunk), queued by the march's candidate scan, QL 8;
    - tie: the ties set, first a round over the superchunks that hold the
      higher eidx of GRID_COPIES' pairs, then, from its carried best, a
      round over those of the lower eidx: each aimed ray meets its
      carried (t, larger eidx) again at an equal t and ends with the lower
      eidx;
    - repeat: random rays, each block's first queued superchunk in all 8
      slots;
    - sentinels: every slot a sentinel (nsc, -1, 2^20) from a carried best:
      the rows are that best, with no steps and no entries;
    - ql1, ql16: random rays queued with 1 and 16 slots a block."""
    kind = {"tie": "ties"}.get(case, case)
    if case in ("repeat", "sentinels", "ql1", "ql16"):
        kind = "random"
    (o4, d4), geo, _, aimed, _ = _two_level_set(bench_grid, kind, n)
    dev, nb, scc = o4.device, n // ti.BN, bench_grid.scc
    nsc = geo[0].shape[1]
    init = _no_winner(n, dev)
    ql = {"ql1": 1, "ql16": 16}.get(case, 8)
    queue = _march_queue(geo[0], o4, d4, ql)
    if case == "repeat":
        queue = queue.view(nb, ql)[:, :1].repeat(1, ql).reshape(-1)
    elif case == "sentinels":
        init = ti.march_step_sc_plain(o4, d4, init, queue, *geo,
                                      scc)[:2].contiguous()
        queue = torch.tensor([nsc, -1, 1 << 20] * 3, dtype=torch.int32,
                             device=dev)[:ql].repeat(nb)
    elif case == "tie":
        def sc_of(e):
            return e // ti.BT // scc
        hi = sorted({sc_of(max(p)) for p in GRID_COPIES} - {sc_of(min(p))
                                                             for p in
                                                             GRID_COPIES})
        lo = sorted({sc_of(min(p)) for p in GRID_COPIES})
        init = ti.march_step_sc_plain(o4, d4, init,
                                      _block_queue(nb, hi, ql, dev), *geo,
                                      scc)[:2].contiguous()
        queue = _block_queue(nb, lo, ql, dev)
    queue = queue.contiguous()
    before = ti.march_step_sc.launches
    got = ti.march_step_sc(o4, d4, init, queue, *geo, scc)
    torch.cuda.synchronize()
    assert ti.march_step_sc.launches == before + 1
    want = ti.march_step_sc_plain(o4, d4, init, queue, *geo, scc)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "sentinels":
        assert torch.equal(got[:2].view(torch.int32),
                           init.view(torch.int32))
        assert not got[2:].any()
        return
    assert (got[0] < ti._MISS).any()
    if case == "tie":
        a = torch.from_numpy(aimed).to(dev)
        carried = torch.zeros_like(a, dtype=torch.bool)
        for src, dst in GRID_COPIES:
            if sc_of(src) != sc_of(dst):
                carried |= a == min(src, dst)
        # The carried best held the larger eidx of the pair at the t the
        # round found again; the lower one won.
        assert int(carried.sum()) > 0
        assert torch.equal(got[0][carried], init[0][carried])
        assert bool((init[1][carried].long() > a[carried]).all())
        on = a >= 0
        assert torch.equal(got[1][on].long(), a[on])


def _occlusion_set(prep, kind, n, flat_range):
    """Kernel 2's operands (shadow rays and limits on the card, the flat
    chunk boxes, half boxes and rows of ``prep``) for an adversarial set,
    from a numpy seed, and each ray's aimed eidx or -1. Random rays start
    in the box ``flat_range`` ((lo, hi) of x and z, (lo, hi) of y):
    - blockers: rays at triangles 0, 127, 128 and 255 of the chunks (the
      ends of both halves) from 0.05-0.2 off their planes, each limit
      twice that: the aimed triangle blocks each one;
    - tlim_at_t: the same rays with the limit equal to the aimed
      triangle's own t (strict <: it does not block), computed as the
      kernel does;
    - parked: random rays with random limits, a tenth parked (origin 1e9,
      limit 0) and a tenth with a real origin and a limit of 0 or -1;
    - one_live: one random ray in each 256-ray block, the rest parked;
    - one_chunk: every ray at a triangle of one chunk, from 0.05-2 off,
      limits in (0, 2 × that)."""
    g = np.random.default_rng({"blockers": 31, "tlim_at_t": 31, "parked": 32,
                               "one_live": 33, "one_chunk": 34}[kind])
    rows = [x.cpu().numpy() for x in (prep.mu, prep.mv, prep.mw)]
    ok = _well_formed(rows)
    (x0, x1), (y0, y1) = flat_range
    o = np.stack([g.uniform(x0, x1, n), g.uniform(y0, y1, n),
                  g.uniform(x0, x1, n)])
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tlim = g.uniform(0.0, 2.0 * (x1 - x0), n)
    aimed = np.full(n, -1)
    park = np.zeros(n, bool)
    if kind in ("blockers", "tlim_at_t"):
        ends = np.array([0, 127, 128, 255])
        cand = (np.arange(ok.size // ti.BT)[:, None] * ti.BT + ends).ravel()
        aimed = g.choice(cand[ok[cand]], n)
        dist = g.uniform(0.05, 0.2, n)
        o, d = _aim_at(rows, aimed, dist, g)
        tlim = 2.0 * dist
    elif kind == "one_chunk":
        c = g.choice(np.flatnonzero(ok.reshape(-1, ti.BT).sum(axis=1) > 128))
        aimed = c * ti.BT + g.choice(np.flatnonzero(ok[c * ti.BT:
                                                       (c + 1) * ti.BT]), n)
        dist = g.uniform(0.05, 2.0, n)
        o, d = _aim_at(rows, aimed, dist, g)
        tlim = g.uniform(0.0, 2.0, n) * dist
    elif kind == "parked":
        park = g.uniform(size=n) < 0.1
        zero = ~park & (g.uniform(size=n) < 0.1)
        tlim[zero] = np.where(g.uniform(size=int(zero.sum())) < 0.5, 0.0,
                              -1.0)
    else:
        park = np.ones(n, bool)
        park[np.arange(0, n, ti.BN) + g.integers(0, ti.BN, n // ti.BN)] = False
    o[:, park], d[:, park], tlim[park] = 1e9, 0.5773503, 0.0
    aimed[park] = -1
    dev = prep.mu.device
    o4, d4 = (torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [x, np.full((1, n), w)]), dtype=np.float32)).to(dev)
        for x, w in ((o, 1.0), (d, 0.0)))
    lim = torch.from_numpy(tlim.astype(np.float32)).to(dev)
    if kind == "tlim_at_t":
        # t of the aimed triangle in the kernel's terms (trace_common.cuh
        # intersect: -w_o / w_d, each 4-term dot left to right).
        a = torch.from_numpy(aimed).to(dev)
        mw = prep.mw[:, a]
        w_d = d4[0] * mw[0] + d4[1] * mw[1] + d4[2] * mw[2] + d4[3] * mw[3]
        w_o = o4[0] * mw[0] + o4[1] * mw[1] + o4[2] * mw[2] + o4[3] * mw[3]
        lim = (-w_o / w_d).contiguous()
    return (o4, d4, lim, prep.bounds, prep.sub_bounds, prep.mu, prep.mv,
            prep.mw), aimed


@pytest.mark.parametrize("n", [256, 393216])
@pytest.mark.parametrize("kind", ["blockers", "tlim_at_t", "parked",
                                  "one_live", "one_chunk"])
@pytest.mark.parametrize("where", ["demo", "grid"])
def test_occlusion_kernel_adversarial(scene, bench_grid, where, kind, n):
    """Kernel 2 (the block-cooperative any-hit walk) against its plain
    version on the adversarial shadow-ray sets of _occlusion_set, on the
    demo scene and on the bench grid's 376 flat chunks; the aimed blockers
    block, and a limit at the blocker's own t does not."""
    if where == "demo":
        prep = ti.prepare_trace_inputs(scene.to("cuda"))
        box = ((-2.5, 2.5), (-2.5, 2.5))
    else:
        prep = bench_grid
        box = ((-14.0, 14.0), (-0.5, 3.0))
    args, aimed = _occlusion_set(prep, kind, n, box)
    before = ti.occluded.launches
    got = ti.occluded(*args)
    torch.cuda.synchronize()
    assert ti.occluded.launches == before + 1
    want = ti.occluded_plain(*args)
    assert torch.equal(got, want.occ)
    on = torch.from_numpy(aimed >= 0).cuda()
    if kind == "blockers":
        assert bool(got[on].all())
    elif kind == "tlim_at_t":
        # Mostly open at tlim = t (those aimed up at a sphere's lowest
        # triangles start under the floor, which blocks them: 12% of the
        # grid's); just past it, every aimed ray is blocked.
        assert float(got[on].float().mean()) < 0.25
        past = list(args)
        past[2] = torch.nextafter(args[2], torch.full_like(args[2],
                                                           torch.inf))
        assert bool(ti.occluded(*past)[on].all())
    elif kind == "one_live":
        assert int((args[0][0] < 1e8).sum()) == n // ti.BN
    else:
        assert 0 < int(got.sum()) < int((args[2] > 0).sum())
    assert not bool(got[args[2] <= 0].any())  # parked: never occluded


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
@pytest.mark.parametrize("regen", [True, False], ids=["regen", "standard"])
def test_superchunk_render_cuda_matches_cpu(grid, regen, nee):
    """The mid-size sphere grid on the card (kernel 3, and kernel 2 for
    shadow rays) against the CPU at 48x32. With NEE a few shadow queries
    whose cos_i is within rounding of 0 are posted on one device and not on
    the other: a segment more or less, for a contribution ~0. So segments
    agree on >= 99% of the agreeing pixels there, not on all."""
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    scene = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen=regen, nee=nee,
                       bounces=4)
    cam = grid_camera(48, 32, n=4)
    a = render_radiance(scene.to("cuda"), cam, cfg, 3)
    b = render_radiance(scene, cam, cfg, 3)
    ok = (torch.abs(a.radiance.cpu() - b.radiance) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= 0.99
    same = a.segments.cpu()[ok] == b.segments[ok]
    assert same.float().mean() >= (0.99 if nee else 1.0)


def _march_args(grid, n, carried):
    """Kernel 7's operands on the mid grid: the random rays of _sc_rays,
    queues from the march's own candidate scan (sentinels and repeats
    among them) and, with ``carried``, the best of a first round."""
    from gdpathtracing_torch.core.vec import Vec3
    o4, d4 = _sc_rays(n)
    nsc = grid.sc_bounds.shape[1]
    live = o4[0] < 1e8
    _, ss = ti.march_next_candidates(
        grid, Vec3(*o4[:3]), Vec3(*d4[:3]), live,
        torch.full((n,), -torch.inf, device="cuda"),
        torch.full((n,), -1, dtype=torch.int64, device="cuda"),
        torch.full((n,), 1e9, device="cuda"), k=6)
    queue = ti.march_block_queue(ss, nsc, 8)[0]
    init = torch.stack([torch.full((n,), 1e9, device="cuda"),
                        torch.full((n,), float(ti.BIG_E), device="cuda")])
    geo = (grid.sc_bounds, grid.chunk_bounds, grid.mu_pad, grid.mv_pad,
           grid.mw_pad, grid.scc)
    if carried:
        init = ti.march_step_sc_plain(o4, d4, init, queue, *geo)[:2]
        queue = ti.march_block_queue(ss[1:], nsc, 8)[0]
    return (o4, d4, init.contiguous(), queue) + geo


@pytest.mark.parametrize("carried", [False, True], ids=["spawn", "carried"])
@pytest.mark.parametrize("n", [256, 4096])
def test_march_step_kernel_matches_plain(grid, n, carried):
    args = _march_args(grid, n, carried)
    before = ti.march_step_sc.launches
    got = ti.march_step_sc(*args)
    torch.cuda.synchronize()
    assert ti.march_step_sc.launches == before + 1
    want = ti.march_step_sc_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[0] < ti._MISS).any()
    # A queue of every superchunk from no winner is kernel 3.
    nsc = grid.sc_bounds.shape[1]
    full = torch.arange(nsc, dtype=torch.int32, device="cuda").repeat(
        n // ti.BN)
    init = torch.stack([torch.full((n,), 1e9, device="cuda"),
                        torch.full((n,), float(ti.BIG_E), device="cuda")])
    one = ti.march_step_sc(*args[:2], init, full, *args[4:])
    lite = ti.closest_hit_sc_lite(*args[:2], *args[4:6], grid.group_bounds,
                                  *args[6:])
    assert torch.equal(one[[0, 2, 3]], lite[[0, 2, 3]])


@pytest.mark.parametrize("kernel", ["classic", "loop"])
@pytest.mark.parametrize("n", [256, 4096])
def test_classic_kernels_match_plain(scene, n, kernel):
    """Kernels 8 and 9 against their plain versions on the demo's raw chunk
    boxes: t bit for bit, idx equal."""
    s = scene.to("cuda")
    prep = ti.prepare_trace_inputs(s)
    o4, d4 = _rays(n, 0)
    args = (o4.cuda(), d4.cuda(), s.isect_chunk_bounds.contiguous(),
            prep.mu, prep.mv, prep.mw)
    fn = ti.closest_hit_classic if kernel == "classic" \
        else ti.closest_hit_loop
    plain = ti.closest_hit_classic_plain if kernel == "classic" \
        else ti.closest_hit_loop_plain
    before = fn.launches
    t, idx = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want_t, want_i = plain(*args)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(idx, want_i) and (t < ti._MISS).any()


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_march_render_cuda_matches_cpu(grid, nee):
    """Regen with the march (kernel 7) on the mid grid: the card's frame
    equals the card's no-march frame bit for bit, and the CPU's within the
    image tolerance (segments on >= 99% of the agreeing pixels with NEE,
    as test_superchunk_render_cuda_matches_cpu allows)."""
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    scene = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen=True, nee=nee,
                       bounces=4, regen_march=True)
    cam = grid_camera(48, 32, n=4)
    before = ti.march_step_sc.launches
    a = render_radiance(scene.to("cuda"), cam, cfg, 3)
    assert ti.march_step_sc.launches > before
    b = render_radiance(scene, cam, cfg, 3)
    c = render_radiance(scene.to("cuda"), cam, cfg.replace(regen_march=False),
                        3)
    for k in ("radiance", "depth", "segments", "normal"):
        assert torch.equal(getattr(a, k), getattr(c, k)), k
    ok = (torch.abs(a.radiance.cpu() - b.radiance) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= 0.99
    same = a.segments.cpu()[ok] == b.segments[ok]
    assert same.float().mean() >= (0.99 if nee else 1.0)


def _soft_args(scene, n, device):
    """Kernel 5's operands: random shadow rays with limits in (0, 6), a
    quarter of them parked (limit 0), over the soft-inflated chunk boxes
    (edge_eps 0.05) and the triangles' edge openness."""
    s = scene.to(device)
    prep = ti.prepare_trace_inputs(s)
    o4, d4 = _rays(n, 5)
    g = np.random.default_rng(6)
    tmax = g.uniform(0.0, 6.0, n).astype(np.float32)
    tmax[g.uniform(size=n) < 0.25] = 0.0
    return (o4.to(device), d4.to(device), torch.from_numpy(tmax).to(device),
            ti.soft_bounds(s.isect_chunk_bounds, 0.05), prep.mu, prep.mv,
            prep.mw, s.tri_edge_open[s.isect_tri.long()].T.contiguous())


@pytest.mark.parametrize("n", [256, 4096])
def test_soft_occlusion_kernel_matches_plain(scene, n):
    """Kernel 5 against its plain version: margins bit for bit, eidx
    equal, with candidates found and all-closed ties at 1.0 among them."""
    args = _soft_args(scene, n, "cuda")
    before = ti.soft_occluded.launches
    margin, eidx = ti.soft_occluded(*args)
    torch.cuda.synchronize()
    assert ti.soft_occluded.launches == before + 1
    want = ti.soft_occluded_plain(*args)
    assert torch.equal(margin.view(torch.int32),
                       want.margin.view(torch.int32))
    assert torch.equal(eidx, want.eidx)
    assert (margin > -1e8).any() and (margin == 1.0).any()


def test_albedo_gradient_cuda_matches_cpu(scene):
    """The differentiable standard loop (kernel 1 as the finder) on the
    card against the CPU at 32x32: the images by the render tolerance, the
    albedo gradient of the mean radiance within 5% of its largest
    component (about 1% of pixels take another path after the card's
    other sqrt/sin/cos rounding, and each moves this image-wide sum)."""
    from gdpathtracing_torch.diff import replace_albedo
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=4,
                       differentiable=True)
    cam = demo_camera(32, 32)
    out = []
    for s in (scene.to("cuda"), scene):
        alb = s.mat_albedo.clone().requires_grad_(True)
        rad = render_radiance(replace_albedo(s, alb), cam, cfg, 3).radiance
        (g,) = torch.autograd.grad(rad.mean(), alb)
        out.append((rad.detach().cpu(), g.cpu()))
    (ra, ga), (rb, gb) = out
    ok = (torch.abs(ra - rb) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= 0.99
    assert bool(torch.isfinite(ga).all()) and float(gb.abs().max()) > 0
    assert float((ga - gb).abs().max()) <= 0.05 * float(gb.abs().max())


def test_pcg2d_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = np.random.default_rng(0)
    s = [torch.from_numpy(g.integers(0, 2 ** 32, 4096, dtype=np.int64))
         for _ in range(2)]
    (u, v), (sx, sy) = rng.pcg2d((s[0].cuda(), s[1].cuda()))
    (u0, v0), (sx0, sy0) = rng.pcg2d((s[0], s[1]))
    assert torch.equal(sx.cpu(), sx0) and torch.equal(sy.cpu(), sy0)
    assert torch.equal(u.cpu(), u0) and torch.equal(v.cpu(), v0)


def _camera_paths(cam, device, w=64, h=32, frame=1):
    """Camera rays and PCG2D words of a w x h frame of ``cam`` (a function
    of w and h) on ``device``."""
    cfg = RenderConfig(traversal=Traversal.MEGA)
    pids = torch.arange(w * h, device=device)
    seed = rng.prng_seed(pids % w, torch.div(pids, w, rounding_mode="floor"),
                         frame)
    return cam(w, h).to(device).generate_rays(pids, seed, cfg)


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_mega_step_kernel_matches_plain(scene, nee, bounce):
    """Kernel 10 against its plain version on the card, one bounce of 2048
    camera paths (bounce 1 from the plain version's bounce 0): the whole
    state equal bit for bit."""
    from gdpathtracing_torch.ops import megakernel as mk
    dev = scene.to("cuda")
    prep = ti.prepare_trace_inputs(dev)
    cfg = RenderConfig(traversal=Traversal.MEGA, nee=nee)
    lt = mk._build_light_block(prep.lights if nee else None, "cuda")
    ray, seed = _camera_paths(demo_camera, "cuda")
    fs, iv = mk.pack_state(ray, seed)
    geo = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw, prep.tab,
           lt)
    if bounce:
        fs, iv = mk.mega_step_plain(fs, iv, *geo, 0, cfg)
    before = mk.mega_step.launches
    got = mk.mega_step(fs, iv, *geo, bounce, cfg)
    torch.cuda.synchronize()
    assert mk.mega_step.launches == before + 1
    want = mk.mega_step_plain(fs, iv, *geo, bounce, cfg)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool((want[0][12] > 0).any())


@pytest.mark.parametrize("scene_name", ["demo", "mid"])
def test_fused_paths_kernel_matches_plain(scene, scene_name):
    """Kernel 11 against its plain version on the card, 3 bounces of 2048
    camera paths, on the demo scene and on the mid grid (34 chunks, walked
    flat): every output equal bit for bit."""
    from gdpathtracing_torch.ops import fused as fu
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    if scene_name == "demo":
        s, cam = scene.to("cuda"), demo_camera
    else:
        s = build_sphere_grid(n=4, sphere_detail=12, device="cuda")
        cam = lambda w, h: grid_camera(w, h, n=4)  # noqa: E731
    prep = ti.prepare_trace_inputs(s)
    cfg = RenderConfig(traversal=Traversal.FUSED, bounces=3)
    ray, seed = _camera_paths(cam, "cuda")
    args = (*fu.pack_paths(ray, seed), prep.bounds, prep.mu, prep.mv,
            prep.mw, fu._build_table(s), fu._build_mats(s))
    before = fu.fused_paths.launches
    got = fu.fused_paths(*args, cfg)
    torch.cuda.synchronize()
    assert fu.fused_paths.launches == before + 1
    want = fu.fused_paths_plain(*args, cfg)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool((want[0][3] < 1e9).any())


def _demo_cuda(scene):
    s = scene.to("cuda")
    return s, ti.prepare_trace_inputs(s)


def _packed(o, d, n):
    """(4, n) float32 (o, 1) and (d, 0) on the card from (3, n) arrays."""
    return tuple(torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [x, np.full((1, n), w)]), dtype=np.float32)).cuda()
        for x, w in ((o, 1.0), (d, 0.0)))


def _soft_set(s, prep, kind, n):
    """Kernel 5's operands on the demo (rays and limits on the card, the
    boxes grown by edge_eps 0.05, the rows, the openness) for an
    adversarial set, from a numpy seed:
    - closed_ties: every edge marked closed (so every crossing inside a
      triangle scores exactly 1.0) and random rays from inside the room
      with limit 8, which cross several walls: ties at 1.0 across lanes
      and chunks, the lowest eidx wins;
    - sparse: random rays, 1-7 of them live in each 256-ray block, the
      rest parked (origin 1e9, limit 0): k < 8 on every chunk;
    - dense: the rays of each block aimed at triangles of one chunk from
      0.05-0.5 off their planes, limit twice that: k = 256 on that chunk,
      where the rays' own threads sweep;
    - parked: random rays, a quarter with limit 0 inside the room and a
      tenth parked at 1e9;
    - no_need: every other block's rays far outside the room pointing
      away (no ray of the block needs any chunk), random rays in the
      others."""
    g = np.random.default_rng({"closed_ties": 41, "sparse": 42, "dense": 43,
                               "parked": 44, "no_need": 45}[kind])
    o = g.uniform(-2.5, 2.5, (3, n))
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tmax = g.uniform(0.0, 6.0, n)
    park = np.zeros(n, bool)
    eo = s.tri_edge_open[s.isect_tri.long()].T.contiguous()
    if kind == "closed_ties":
        eo = torch.zeros_like(eo)
        tmax[:] = 8.0
    elif kind == "sparse":
        park[:] = True
        for b in range(n // ti.BN):
            live = g.choice(ti.BN, g.integers(1, 8), replace=False)
            park[b * ti.BN + live] = False
    elif kind == "dense":
        rows = [x.cpu().numpy() for x in (prep.mu, prep.mv, prep.mw)]
        ok = _well_formed(rows)
        chunks = np.flatnonzero(ok.reshape(-1, ti.BT).sum(axis=1) > 32)
        aimed = np.empty(n, np.int64)
        for b in range(n // ti.BN):
            c = g.choice(chunks)
            cols = np.flatnonzero(ok[c * ti.BT:(c + 1) * ti.BT]) + c * ti.BT
            aimed[b * ti.BN:(b + 1) * ti.BN] = g.choice(cols, ti.BN)
        dist = g.uniform(0.05, 0.5, n)
        o, d = _aim_at(rows, aimed, dist, g)
        tmax = 2.0 * dist
    elif kind == "parked":
        tmax[g.uniform(size=n) < 0.25] = 0.0
        park = g.uniform(size=n) < 0.1
    else:
        away = (np.arange(n) // ti.BN) % 2 == 0
        o[:, away] = 50.0
        d[:, away] = 0.5773503
    o[:, park], d[:, park], tmax[park] = 1e9, 0.5773503, 0.0
    o4, d4 = _packed(o, d, n)
    return (o4, d4, torch.from_numpy(tmax.astype(np.float32)).cuda(),
            ti.soft_bounds(s.isect_chunk_bounds, 0.05), prep.mu, prep.mv,
            prep.mw, eo)


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["closed_ties", "sparse", "dense", "parked",
                                  "no_need"])
def test_soft_occlusion_kernel_adversarial(scene, kind, n):
    """Kernel 5 (the block-cooperative walk with a warp arg-max) against
    its plain version on the adversarial sets of _soft_set: margins bit
    for bit, eidx equal; the ties at 1.0 go to the lowest eidx, every
    parked ray finds no candidate, and a block that needs no chunk none."""
    s, prep = _demo_cuda(scene)
    args = _soft_set(s, prep, kind, n)
    before = ti.soft_occluded.launches
    margin, eidx = ti.soft_occluded(*args)
    torch.cuda.synchronize()
    assert ti.soft_occluded.launches == before + 1
    want = ti.soft_occluded_plain(*args)
    assert torch.equal(margin.view(torch.int32),
                       want.margin.view(torch.int32))
    assert torch.equal(eidx, want.eidx)
    assert bool((margin[args[2] <= 0] == -1e9).all())
    found = margin > -1e8
    if kind == "closed_ties":
        assert int((margin == 1.0).sum()) > n // 4
    elif kind == "no_need":
        away = (torch.arange(n, device="cuda") // ti.BN) % 2 == 0
        assert not bool(found[away].any()) and not bool(
            want.sweeps[away].any())
        assert n == ti.BN or bool(found[~away].any())
    elif kind == "sparse":
        assert bool((want.tests.view(-1, ti.BN) > 0).sum(dim=1).le(7).all())
    elif kind == "dense":
        assert int(found.sum()) > n // 2
    else:
        assert bool(found.any())


def _loop_set(s, prep, kind, n):
    """Kernel 9's operands on the demo (rays on the card, the raw chunk
    boxes, the rows) for an adversarial set, from a numpy seed, and for
    one_gate the block of r0 and the chunk c (else None):
    - one_gate: the camera rays of a square frame; chunk c's box shrunk to
      a point on the path of one ray r0 of the block with the most hits
      (c the chunk most of that block's rays hit): only r0's gate passes
      on c, and every ray of its block sweeps c;
    - one_live: one camera ray live in each 256-ray block (one that hits
      where the block has one), the rest parked;
    - ties: rays at triangles copied within a chunk and into a later chunk
      (boxes grown to hold them), random rays and a tenth parked: equal t,
      the lower index wins;
    - two_rays: random rays with the lower or the upper half of every
      block parked in turn, and a third of the rest parked at random, so
      the gates of ray i and ray i + 128 of a block differ."""
    g = np.random.default_rng({"one_gate": 51, "one_live": 52, "ties": 53,
                               "two_rays": 54}[kind])
    bounds = s.isect_chunk_bounds.clone()
    mu, mv, mw = prep.mu, prep.mv, prep.mw
    focus = None
    if kind in ("one_gate", "one_live"):
        side = int(np.sqrt(n))
        pids = torch.arange(n)
        ray, _ = demo_camera(side, side).generate_rays(
            pids, rng.prng_seed(pids % side, pids // side, 1), RenderConfig())
        o4, d4 = ti.pack_rays(ray)
        o4, d4 = o4.cuda(), d4.cuda()
        if kind == "one_live":  # a ray that hits, where a block has one
            t, _ = ti.closest_hit_classic_plain(o4, d4, bounds, mu, mv, mw)
            key = torch.from_numpy(g.uniform(size=n)).cuda() \
                + (t < ti._MISS).double()
            live = key.view(-1, ti.BN).argmax(dim=1) \
                + torch.arange(0, n, ti.BN, device=key.device)
            park = torch.ones(n, dtype=torch.bool, device=key.device)
            park[live] = False
            o4[:3, park] = 1e9
            d4[:3, park] = 0.5773503
        else:
            t, idx = ti.closest_hit_classic_plain(o4, d4, bounds, mu, mv, mw)
            hit = (t < ti._MISS).view(-1, ti.BN)
            block = int(hit.sum(dim=1).argmax())
            sl = slice(block * ti.BN, (block + 1) * ti.BN)
            c = int(torch.bincount(idx[sl][hit[block]] // ti.BT).argmax())
            r0 = int(torch.nonzero(hit[block] & (idx[sl] // ti.BT == c))[0])
            r0 += block * ti.BN
            p = o4[:3, r0] + t[r0] * d4[:3, r0]
            bounds[0:3, c], bounds[3:6, c] = p - 1e-4, p + 1e-4
            focus = (block, c)
        return (o4, d4, bounds.contiguous(), mu, mv, mw), focus
    o = g.uniform(-2.5, 2.5, (3, n))
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    park = np.zeros(n, bool)
    if kind == "ties":
        mu, mv, mw = mu.clone(), mv.clone(), mw.clone()
        nc = bounds.shape[1]
        copies = ((1 * ti.BT + 10, 1 * ti.BT + 200),
                  (2 * ti.BT + 30, (nc - 1) * ti.BT + 100))
        for src, dst in copies:
            for x in (mu, mv, mw):
                x[:, dst] = x[:, src]
            cs, cd = src // ti.BT, dst // ti.BT
            bounds[0:3, cd] = torch.minimum(bounds[0:3, cd], bounds[0:3, cs])
            bounds[3:6, cd] = torch.maximum(bounds[3:6, cd], bounds[3:6, cs])
        rows = [x.cpu().numpy() for x in (mu, mv, mw)]
        aimed = g.choice([src for src, _ in copies], n // 2)
        o[:, :n // 2], d[:, :n // 2] = _aim_at(rows, aimed,
                                               g.uniform(0.05, 0.3, n // 2),
                                               g)
        park = g.uniform(size=n) < 0.1
    else:
        half = (np.arange(n) % ti.BN) < ti.BN // 2
        upper = (np.arange(n) // ti.BN) % 2 == 1
        park = np.where(upper, ~half, half) | (g.uniform(size=n) < 1 / 3)
    o[:, park], d[:, park] = 1e9, 0.5773503
    o4, d4 = _packed(o, d, n)
    return (o4, d4, bounds.contiguous(), mu.contiguous(), mv.contiguous(),
            mw.contiguous()), focus


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["one_gate", "one_live", "ties",
                                  "two_rays"])
def test_closest_hit_loop_kernel_adversarial(scene, kind, n):
    """Kernel 9 (the block gate on double-buffered staging) against its
    plain version on the adversarial sets of _loop_set: t bit for bit, idx
    equal; on one_gate the block of r0 sweeps the shrunk chunk for all its
    rays (many more of them win there than kernel 8 lets, whose own gates
    fail), and tied triangles go to the lower index."""
    s, prep = _demo_cuda(scene)
    args, focus = _loop_set(s, prep, kind, n)
    before = ti.closest_hit_loop.launches
    t, idx = ti.closest_hit_loop(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_loop.launches == before + 1
    want_t, want_i = ti.closest_hit_loop_plain(*args)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(idx, want_i)
    assert bool((t < ti._MISS).any())
    parked = args[0][0] > 1e8
    assert bool((t[parked] == ti._MISS).all())
    if kind == "one_gate":
        block, c = focus
        t8, i8 = ti.closest_hit_classic(*args)
        sl = slice(block * ti.BN, (block + 1) * ti.BN)
        in9 = (idx[sl] // ti.BT == c) & (t[sl] < ti._MISS)
        in8 = (i8[sl] // ti.BT == c) & (t8[sl] < ti._MISS)
        assert int(in9.sum()) > 4 * int(in8.sum()) >= 4
    elif kind == "ties":
        lower = {1 * ti.BT + 10, 2 * ti.BT + 30}
        won = idx[:n // 2][t[:n // 2] < ti._MISS].tolist()
        assert sum(i in lower for i in won) > 0.8 * len(won)
        assert not any(i in (1 * ti.BT + 200,
                             (args[2].shape[1] - 1) * ti.BT + 100)
                       for i in won)


def _classic_set(s, prep, kind, n):
    """Kernel 8's operands on the demo (rays on the card, the raw chunk
    boxes, the rows) for an adversarial set, from a numpy seed, and for
    tmin_at_best the lanes of the target ray and its winner (else None):
    - ties, one_live: kernel 9's sets (_loop_set): equal t within a chunk
      and across chunks; one passing ray in each block;
    - tmin_at_best: a ray R along -z is put in every block (among random
      rays); a copy of R's winning triangle, moved to make its t a few ulp
      lower, takes a slot of the last chunk, whose raw box is cut so that
      R's slab test gives tmin exactly R's best t. The strict gate skips
      that chunk, so R keeps its winner; a <= gate would sweep it and find
      the copy;
    - no_need: the odd blocks' rays far outside the room pointing away
      (no ray of the block needs any chunk), random rays in the others;
    - dense: every block's 256 rays within 1e-4 of one random ray, so the
      needing warps are full and the rays' own threads sweep."""
    if kind in ("ties", "one_live"):
        return _loop_set(s, prep, kind, n)[0], None
    g = np.random.default_rng({"tmin_at_best": 61, "no_need": 62,
                               "dense": 63}[kind])
    bounds = s.isect_chunk_bounds.clone()
    mu, mv, mw = prep.mu, prep.mv, prep.mw
    o = g.uniform(-2.5, 2.5, (3, n))
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    focus = None
    if kind == "no_need":
        away = (np.arange(n) // ti.BN) % 2 == 1
        o[:, away] = 50.0
        d[:, away] = 0.5773503
    elif kind == "dense":
        # Each block's ray: a random one that hits.
        t0, _ = ti.closest_hit_classic_plain(*_packed(o, d, n), bounds, mu,
                                             mv, mw)
        hits = np.flatnonzero(t0.cpu().numpy() < ti._MISS)
        base = np.repeat(g.choice(hits, n // ti.BN), ti.BN)
        o = o[:, base] + g.uniform(-1e-4, 1e-4, (3, n))
        d = d[:, base] + g.uniform(-1e-4, 1e-4, (3, n))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
    else:
        o4, d4 = _packed(o, d, n)
        lanes = torch.arange(0, n, ti.BN, device="cuda") \
            + torch.from_numpy(g.integers(0, ti.BN, n // ti.BN)).cuda()
        nc = bounds.shape[1]
        for _ in range(100):  # a ray along -z that hits before the last chunk
            r_o = torch.tensor([*g.uniform(-1.5, 1.5, 2), 5.0],
                               dtype=torch.float32, device="cuda")
            o4[:3, lanes] = r_o[:, None]
            d4[:3, lanes] = torch.tensor([[0.0], [0.0], [-1.0]],
                                         device="cuda")
            t0, i0 = ti.closest_hit_classic_plain(o4, d4, bounds, mu, mv, mw)
            t_r, i_r = float(t0[lanes[0]]), int(i0[lanes[0]])
            if t_r < ti._MISS and i_r // ti.BT < nc - 1:
                break
        mu, mv, mw = mu.clone(), mv.clone(), mw.clone()
        dst = (nc - 1) * ti.BT + 7
        for x in (mu, mv, mw):
            x[:, dst] = x[:, i_r]
        # On this ray w_d = -mw[2] and t = w_o / mw[2]: nudge w_o's
        # constant term against mw[2]'s sign until the copy's t is lower.
        one = (o4[:, lanes[:1]], d4[:, lanes[:1]])
        step = -1e-7 if float(mw[2, i_r]) > 0 else 1e-7
        for k in range(1, 64):
            mw[3, dst] = mw[3, i_r] + k * step
            u, v, t, _, _ = ti._uvt([dst], mu, mv, mw, tuple(one[0]),
                                    tuple(one[1]))
            if float(t) < t_r:
                break
        assert 0 < float(t) < t_r and float(u) >= 0 and float(v) >= 0 \
            and float(u + v) <= 1
        # The last chunk's raw box: R's tmin (oz - box max z, in float32)
        # is exactly t_r.
        oz, tr = np.float32(r_o[2].item()), np.float32(t_r)
        z = np.float32(oz - tr)
        for _ in range(64):
            if np.float32(oz - z) == tr:
                break
            z = np.nextafter(z, np.float32(-10.0 if np.float32(oz - z) < tr
                                           else 10.0))
        assert np.float32(oz - z) == tr
        bounds[0:3, nc - 1] = torch.tensor(
            [r_o[0].item() - 0.01, r_o[1].item() - 0.01, float(z) - 1.0],
            device="cuda")
        bounds[3:6, nc - 1] = torch.tensor(
            [r_o[0].item() + 0.01, r_o[1].item() + 0.01, float(z)],
            device="cuda")
        focus = (lanes, i_r, dst)
        return (o4, d4, bounds.contiguous(), mu, mv, mw), focus
    o4, d4 = _packed(o, d, n)
    return (o4, d4, bounds.contiguous(), mu, mv, mw), focus


@pytest.mark.parametrize("n", [256, 262144])
@pytest.mark.parametrize("kind", ["ties", "tmin_at_best", "one_live",
                                  "no_need", "dense"])
def test_closest_hit_classic_kernel_adversarial(scene, kind, n):
    """Kernel 8 (the flat cooperative walk with the strict gate over the raw
    boxes) against its plain version on the adversarial sets of
    _classic_set: t bit for bit, idx equal; tied triangles go to the lower
    index across chunks too; a chunk whose tmin equals a ray's best t is
    not swept; blocks that need nothing find nothing; dense blocks sweep
    on their rays' own threads."""
    s, prep = _demo_cuda(scene)
    args, focus = _classic_set(s, prep, kind, n)
    before = ti.closest_hit_classic.launches
    t, idx = ti.closest_hit_classic(*args)
    torch.cuda.synchronize()
    assert ti.closest_hit_classic.launches == before + 1
    counts = {}
    want_t, want_i = ti.closest_hit_classic_plain(*args, counts=counts)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(idx, want_i)
    assert bool((t < ti._MISS).any())
    assert bool((t[args[0][0] > 1e8] == ti._MISS).all())
    if kind == "ties":
        lower = {1 * ti.BT + 10, 2 * ti.BT + 30}
        won = idx[:n // 2][t[:n // 2] < ti._MISS].tolist()
        assert sum(i in lower for i in won) > 0.8 * len(won)
        assert not any(i in (1 * ti.BT + 200,
                             (args[2].shape[1] - 1) * ti.BT + 100)
                       for i in won)
    elif kind == "tmin_at_best":
        lanes, i_r, dst = focus
        assert bool((idx[lanes] == i_r).all())
        # Were the chunk swept, the copy would win: grow its box.
        grown = args[2].clone()
        grown[0:3, -1] -= 10.0
        grown[3:6, -1] += 10.0
        _, i_g = ti.closest_hit_classic_plain(args[0], args[1],
                                              grown.contiguous(), *args[3:])
        assert bool((i_g[lanes] == dst).all())
    elif kind == "no_need":
        away = (torch.arange(n, device="cuda") // ti.BN) % 2 == 1
        assert bool((t[away] == ti._MISS).all())
    elif kind == "dense":
        assert counts["slots"] <= 1.05 * counts["tests"]


@pytest.fixture(scope="module")
def bvh_scenes():
    """The demo and the bench grid (n=10) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from gdpathtracing_torch.scene.demo import (build_sphere_grid,
                                                grid_camera)
    return {"demo": (build_demo_scene(texture_resolution=8, sphere_detail=6,
                                      device="cuda"), demo_camera(1920, 1080)),
            "grid": (build_sphere_grid(n=10, sphere_detail=16,
                                       device="cuda"),
                     grid_camera(1920, 1080, n=10))}


@pytest.mark.parametrize("tile", ["primary", "bounce 1",
                                  "primary, max_stack 2",
                                  "primary, max_stack 96", "axis-aligned"])
@pytest.mark.parametrize("where", ["demo", "grid"])
def test_trace_bvh_kernel_matches_plain(bvh_scenes, where, tile):
    """The BVH kernel against trace_bvh_plain on the card, bit for bit (t,
    u, v, tri, inst, front, steps), on ops/tiles.py's BVH tiles of 4096
    rays: camera rays with the default stack of 64, one bounce with the
    active mask, a stack of 2 (overflowing, capped at 256 pops) and of 96
    (the kernel's device-memory stack), and axis-aligned rays on box
    planes (1/d = inf; the slab test's NaN must miss the box)."""
    from gdpathtracing_torch.ops import tiles as kt
    from gdpathtracing_torch.render.traverse import trace_bvh, trace_bvh_plain
    s, cam = bvh_scenes[where]
    bt = kt.bvh_tiles(s, cam, RenderConfig(tile_rays=4096))[tile]
    before = trace_bvh.launches
    got = trace_bvh(s, bt.ray, bt.active, bt.max_stack, bt.max_iters)
    torch.cuda.synchronize()
    assert trace_bvh.launches == before + 1
    want = trace_bvh_plain(s, bt.ray, bt.active, bt.max_stack, bt.max_iters)
    for f in ("t", "u", "v"):
        assert torch.equal(getattr(got, f).view(torch.int32),
                           getattr(want, f).view(torch.int32)), f
    for f in ("tri", "inst", "front", "steps", "eidx"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(want.hit.sum()) > 100
    if bt.active is not None:
        assert bool((got.t[~bt.active] == ti._MISS).all())


# ---- the plain oracles, transport and the frame loop on the card ---------

def _tile_rays(s, cam, n=4096):
    """Camera rays of the middle 1080p tile's first n pixels and one
    BRDF-sampled bounce from their hits: {name: (Ray, active)}."""
    from gdpathtracing_torch.ops import tiles as kt
    cfg = RenderConfig(traversal=Traversal.PALLAS)
    prep = ti.prepare_trace_inputs(s)
    ray, hit, sh, seed = kt.middle_rays(s, cam, prep, cfg, n,
                                        kt.middle_tile(cfg))
    return {"primary": (ray, None),
            "bounce 1": kt.bounce_rays(sh, hit, seed, cfg)}


@pytest.mark.parametrize("tile", ["primary", "bounce 1"])
@pytest.mark.parametrize("where", ["demo", "grid"])
def test_unit_matches_kernel_1_and_brute_matches_bvh(bvh_scenes, where,
                                                     tile):
    """On the card, the plain oracles against the kernels: UNIT's winner
    (eidx) is kernel 1's (or the superchunk kernel's) on >= 99.9% of the
    rays; on those, UNIT's epilogue over the kernels' unfused sums
    (ops/tiles.py unit_t_witness) gives t within the pinned tolerance
    (rtol 1e-6 + atol 5e-6) on every ray, and UNIT's own t (a cuBLAS
    product, summed with fused multiply-adds) lies within two roundings of
    that contraction (ROADMAP §3); BRUTE's triangle and instance are the
    BVH kernel's on >= 99.9%, t within the pinned tolerance on all of
    those; on the demo each equals its CPU run there."""
    from gdpathtracing_torch.ops import tiles as kt
    from gdpathtracing_torch.render.intersect import trace_brute, trace_unit
    from gdpathtracing_torch.render.traverse import trace_bvh
    s, cam = bvh_scenes[where]
    ray, active = _tile_rays(s, cam)[tile]
    prep = ti.prepare_trace_inputs(s)
    unit = trace_unit(s, ray, active)
    k1 = ti.trace_pallas(s, ray, active, prep)
    same = unit.eidx == k1.eidx
    assert float(same.double().mean()) >= 0.999
    both = same & k1.hit
    assert int(both.sum()) > 1000
    t_w, bound = (x[both] for x in kt.unit_t_witness(s, ray, k1.eidx,
                                                       k1.t))
    assert bool(torch.isclose(t_w, k1.t[both], rtol=1e-6, atol=5e-6).all())
    assert bool(((unit.t[both] - k1.t[both]).abs().double() <= bound).all())
    brute = trace_brute(s, ray, active)
    bvh = trace_bvh(s, ray, active)
    same = (brute.tri == bvh.tri) & (brute.inst == bvh.inst)
    assert float(same.double().mean()) >= 0.999
    on = same & bvh.hit
    assert bool(torch.isclose(brute.t[on], bvh.t[on], rtol=1e-6,
                              atol=5e-6).all())
    if where != "demo":
        return
    cpu = ray.__class__(*(type(v)(*(x.cpu() for x in v)) for v in ray))
    cact = None if active is None else active.cpu()
    for got, fn in ((unit, trace_unit), (brute, trace_brute)):
        want = fn(s.to("cpu"), cpu, cact)
        eq = (got.tri.cpu() == want.tri) & (got.inst.cpu() == want.inst)
        assert float(eq.double().mean()) >= 0.999


def test_oracles_take_the_first_of_equal_hits_on_the_card():
    """torch.argmin on CUDA returns the first index of equal minima, as
    on the CPU: four copies of a quad at one place, every ray's winner
    the lowest instance (BRUTE) and expanded index (UNIT)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gdpathtracing_torch.render.intersect import trace_brute, trace_unit
    from gdpathtracing_torch.render.types import Ray
    from gdpathtracing_torch.core.vec import Vec3
    from gdpathtracing_torch.scene.materials import Material
    from gdpathtracing_torch.scene.primitives import quad_ccw
    from gdpathtracing_torch.scene.scene import SceneBuilder
    b = SceneBuilder()
    mesh = b.add_mesh([quad_ccw([-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                [-1, 1, 0])])
    for k in range(4):
        b.add_instance(mesh, np.eye(4, dtype=np.float32)[:3],
                       materials=[Material(albedo=(0.2 * k, 0.5, 0.5))])
    s = b.build("cuda")
    g = np.random.default_rng(5)
    n = 65536
    o = torch.from_numpy(np.stack([g.uniform(-0.7, 0.7, n),
                                   g.uniform(-0.7, 0.7, n),
                                   np.full(n, 2.0)]).astype(np.float32))
    d = torch.from_numpy(np.stack([g.uniform(-0.1, 0.1, n),
                                   g.uniform(-0.1, 0.1, n),
                                   -np.ones(n)]).astype(np.float32))
    for dev in ("cuda", "cpu"):
        ray = Ray(Vec3(*o.to(dev)), Vec3(*d.to(dev)))
        sd = s.to(dev)
        assert bool((trace_brute(sd, ray).inst == 0).all())
        unit = trace_unit(sd, ray)
        first = torch.stack([torch.nonzero(sd.isect_tri == t)[0, 0]
                             for t in range(2)])
        assert torch.equal(unit.eidx.long(), first[unit.tri.long()])


@pytest.mark.parametrize("change", [
    dict(traversal=Traversal.BRUTE, rr_start=2, bounces=5),
    dict(traversal=Traversal.UNIT, nee=True, soft_shadows=0.05),
    dict(traversal=Traversal.UNIT, regen=True, nee=True)],
    ids=["brute_rr", "unit_soft", "unit_regen_nee"])
def test_oracle_render_cuda_matches_cpu(scene, change):
    """BRUTE with Russian roulette, UNIT with soft shadows and UNIT regen
    with NEE at 32x24 on the card and on the CPU: radiance within 1e-4 on
    >= 99% of the pixels (the card rounds sqrt, sin and cos as IEEE and
    CUDA do; ROADMAP §3), segments equal there."""
    cam = demo_camera(32, 24)
    cfg = RenderConfig(**{"bounces": 3, **change})
    a = render_radiance(scene.to("cuda"), cam, cfg, 2)
    b = render_radiance(scene, cam, cfg, 2)
    assert a.radiance.device.type == "cuda"
    ok = (torch.abs(a.radiance.cpu() - b.radiance) <= 1e-4).all(dim=-1)
    assert float(ok.double().mean()) >= 0.99
    assert torch.equal(a.segments.cpu()[ok], b.segments[ok])


def test_engine_on_the_card_matches_cpu(scene):
    """Four Engine steps with temporal accumulation and the denoiser under
    a moving camera, on the card and on the CPU: the state stays on the
    card, the images agree within 2e-3 on >= 95% of the pixels."""
    from gdpathtracing_torch import DenoisingMode, Engine
    from gdpathtracing_torch.render.camera import Camera
    cfg = RenderConfig(traversal=Traversal.UNIT, bounces=2,
                       denoising=DenoisingMode.TEMPORAL, spatial_denoise=True)
    gpu, cpu = Engine(scene.to("cuda"), cfg), Engine(scene, cfg)
    for k in range(4):
        a = 0.08 * k
        cam = Camera.looking_at((9.7694 * np.sin(a), 0.3 * k,
                                 9.7694 * np.cos(a)), (0, 0, 0),
                                fov_deg=79.5, width=32, height=24)
        x, y = gpu.step(cam), cpu.step(cam)
        assert x.device.type == "cuda"
        ok = torch.isclose(x.cpu(), y, rtol=2e-3, atol=2e-3).all(dim=-1)
        assert float(ok.double().mean()) >= 0.95
    assert all(t.device.type == "cuda" for t in gpu._state)
    assert gpu.to_uint8(x).shape == (24, 32, 3)


def test_fused_regen_nee_kernel_matches_plain(monkeypatch):
    """Regen's fused NEE at 64x48 on the card (the demo, 5 bounces): one
    kernel 4 launch an iteration and no kernel 2 launch; the frame bit for
    bit equal to the same frame with kernel 4's plain version on the card
    and to regen's unfused NEE frame there, and its segments equal to the
    standard loop + NEE frame's with radiance within 1e-6."""
    from gdpathtracing_torch.render import regen
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6)
    cam = demo_camera(64, 48)
    cfg = RenderConfig(traversal=Traversal.PALLAS, nee=True,
                       regen_fuse_nee=True)
    k4, k2 = ti.closest_hit_rows_nee.launches, ti.occluded.launches
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 3)
    torch.cuda.synchronize()
    iters = regen.render_radiance_regen.iterations
    assert ti.closest_hit_rows_nee.launches - k4 == iters > 5
    assert ti.occluded.launches == k2
    unfused = render_radiance(scene, cam, cfg.replace(regen_fuse_nee=False),
                              3)
    std = render_radiance(scene, cam, cfg.replace(regen=False), 3)
    monkeypatch.setattr(ti, "closest_hit_rows_nee",
                        ti.closest_hit_rows_nee_plain)
    plain = render_radiance(scene, cam, cfg, 3)
    for a, b, c in zip(got, plain, unfused):
        assert a.device.type == "cuda"
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(got.segments, std.segments)
    assert torch.allclose(got.radiance, std.radiance, rtol=1e-6, atol=1e-6)


def test_native_builder_on_the_host():
    """The native BVH builder builds on the card's host and gives the
    NumPy builder's tree bit for bit on 20000 random triangles."""
    from gdpathtracing_torch.bvh import native
    from gdpathtracing_torch.bvh.blas import BLASBuilder, Surface
    if not torch.cuda.is_available():
        pytest.skip("runs on the GPU machine's host")
    assert native.available()
    g = np.random.default_rng(11)
    v0 = g.uniform(-1, 1, (20000, 3))
    pos = np.stack([v0, v0 + g.uniform(-0.3, 0.3, (20000, 3)),
                    v0 + g.uniform(-0.3, 0.3, (20000, 3))],
                   axis=1).astype(np.float32)
    trees = []
    for backend in ("native", "numpy"):
        b = BLASBuilder(backend=backend)
        b.build_mesh([Surface(positions=pos)])
        trees.append(b.finalize())
    for k in ("node_min", "node_max", "node_left", "node_right",
              "node_first", "node_count", "tri_pos"):
        assert np.array_equal(getattr(trees[0], k), getattr(trees[1], k)), k


def _shade_inputs(scene, nw, bounces, seed):
    """One regen iteration's inputs on the card: winner rows (kernel 1) of
    random rays in the demo room, 15% of them outside it heading away
    (misses), and random lane stacks: throughput, radiance, prev pdf,
    first-hit AOVs, uint32 seed words, bounces from 0 to the cap, 15% of
    the lanes inactive."""
    from gdpathtracing_torch.core.vec import Vec3
    from gdpathtracing_torch.render.types import Ray
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.cpu().numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (nw, 3)).T
    d = g.normal(size=(3, nw))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    out = g.uniform(size=nw) < 0.15
    o[:, out] = (hi + 1.0)[:, None]
    d[:, out] = np.abs(d[:, out])

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    active = torch.from_numpy(g.uniform(size=nw) < 0.85).cuda()
    o, d = f32(o), f32(d)
    rows = ti.trace_pallas(scene, Ray(Vec3(*o), Vec3(*d)), active).rows
    fs = torch.cat([o, d, f32(g.uniform(0.0, 1.5, (3, nw))),
                    f32(g.uniform(0.0, 2.0, (3, nw))),
                    f32(g.uniform(-1.0, 3.0, (1, nw))),
                    f32(g.uniform(0.0, 1000.0, (1, nw))),
                    f32(g.normal(size=(3, nw)))])
    ints = torch.from_numpy(np.stack(
        [g.integers(0, 1 << 32, nw), g.integers(0, 1 << 32, nw),
         g.permutation(nw), g.integers(0, bounces, nw),
         g.integers(0, 1 << 20, nw), g.integers(0, bounces, nw)])).cuda()
    return rows, fs, ints, active


@pytest.mark.parametrize("case", ["full", "drained"])
def test_regen_shade_kernel_matches_torch(case):
    """Regen's shading kernel against regen's torch body on the card, on
    one iteration's inputs with misses, emissive and mirror hits, lanes at
    the bounce cap and inactive lanes: 393216 lanes (the 1080p wavefront),
    and the first 5120 lanes of 8192-wide stacks (a drain stage's first
    iteration) under another sky, ray_eps and bounce count. Every output
    row bit for bit, the masks and the two counts equal."""
    from gdpathtracing_torch.ops import shade
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6)
    if case == "full":
        cfg, nw, size = RenderConfig(traversal=Traversal.PALLAS), 393216, \
            393216
    else:
        cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=3,
                           ray_eps=3e-3, sky_horizon=(0.3, 0.5, 0.7),
                           sky_zenith=(0.1, 0.2, 1.3))
        nw, size = 8192, 5120
    rows, fs, ints, active = _shade_inputs(scene, nw, cfg.bounces, 5)
    rows, fs, ints, active = (rows[:, :size], fs[:, :size], ints[:, :size],
                              active[:size])
    hit = active & (rows[40] < ti._MISS)
    for kind in (active & ~hit, hit & (rows[23] > 0.0), hit & (rows[24] > 0.5),
                 active & (ints[3] == cfg.bounces - 1), hit & (ints[3] == 0),
                 ~active):
        assert kind.any()
    before = shade.regen_shade.launches
    got = shade.regen_shade(scene, rows, fs, ints, active, cfg)
    torch.cuda.synchronize()
    assert shade.regen_shade.launches == before + 1
    want = shade.regen_shade_plain(scene, rows, fs, ints, active, cfg)
    assert got[0].shape == want[0].shape == (17, size)
    for r in range(17):
        assert torch.equal(got[0][r].view(torch.int32),
                           want[0][r].view(torch.int32)), f"fs row {r}"
    for r in range(6):
        assert torch.equal(got[1][r], want[1][r]), f"ints row {r}"
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert got[4].tolist() == want[4].tolist()
    assert 0 < got[4][0] < size and 0 < got[4][1] < size


@pytest.mark.parametrize("retire", ["log", "scatter"])
def test_regen_shade_frame_matches_torch(retire, monkeypatch):
    """A 320x180 demo frame through regen with 16384 lanes (two drain
    stages) shades in the kernel, one launch an iteration, and equals bit
    for bit the frame with every iteration in the torch body."""
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.render import regen
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6)
    cam = demo_camera(320, 180)
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen_wavefront=16384,
                       regen_retire=retire)
    assert shade.shade_entry(scene, cfg, ti.prepare_trace_inputs(scene),
                             False, False) == "rows"
    before = shade.regen_shade.launches
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 3)
    torch.cuda.synchronize()
    iters = regen.render_radiance_regen.iterations
    assert shade.regen_shade.launches - before == iters > 5
    monkeypatch.setattr(regen, "shade_entry", lambda *a: None)
    want = render_radiance(scene, cam, cfg, 3)
    assert shade.regen_shade.launches - before == iters
    for k in ("radiance", "depth", "normal", "steps", "segments"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.device.type == "cuda"
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


def test_regen_shade_launch_counts():
    """One Engine step of the benchmark's demo (1080p, PALLAS, 5 bounces)
    launches the shading kernel once an iteration, 9 times; a NEE frame
    and an inverse step launch it never."""
    from gdpathtracing_torch import Engine
    from gdpathtracing_torch.diff import inverse
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.render import regen
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene()
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=5, spp=1,
                       nee=False, rr_start=0)
    engine = Engine(scene, cfg)
    cam = demo_camera(1920, 1080)
    before, it0 = shade.regen_shade.launches, \
        regen.render_radiance_regen.iterations
    engine.step(cam)
    torch.cuda.synchronize()
    assert shade.regen_shade.launches - before == \
        regen.render_radiance_regen.iterations - it0 == 9
    small = demo_camera(64, 48)
    target = render_radiance(scene, small, cfg, 0).radiance
    before = shade.regen_shade.launches
    render_radiance(scene, small, cfg.replace(nee=True), 0)
    torch.cuda.synchronize()
    assert shade.regen_shade.launches == before
    step = inverse.value_and_grad_step(
        inverse.replace_albedo, cfg.replace(differentiable=True))
    loss, grads = step(scene.mat_albedo * 0.5, scene, small, target, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and grads.shape == scene.mat_albedo.shape
    assert shade.regen_shade.launches == before


def test_regen_frame_with_no_bounces():
    """A PALLAS regen frame of the demo with ``bounces=0`` renders on the
    card as on the CPU: the gate declines it, so every iteration shades in
    the torch body (the kernels refuse zero bounces), no shading kernel
    launches, every path traces one segment, and the frame agrees with
    the CPU's within the image tolerance (the card's sqrt and division
    round differently)."""
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.render import regen
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6)
    cam = demo_camera(320, 180)
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=0,
                       regen_wavefront=16384)
    before = (shade.regen_shade.launches, shade.regen_shade_lite.launches,
              regen._shade_torch.iterations)
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 3)
    torch.cuda.synchronize()
    iters = regen.render_radiance_regen.iterations
    after = (shade.regen_shade.launches, shade.regen_shade_lite.launches,
             regen._shade_torch.iterations)
    assert iters > 1
    assert [a - b for a, b in zip(after, before)] == [0, 0, iters]
    assert got.radiance.device.type == "cuda"
    assert bool(torch.isfinite(got.radiance).all())
    assert bool((got.segments == 1).all())
    want = render_radiance(scene.to("cpu"), cam, cfg, 3)
    ok = (torch.abs(got.radiance.cpu() - want.radiance) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= 0.99


@pytest.mark.parametrize("where", ["demo", "grid"])
def test_torch_shade_counter_on_the_card(where):
    """One 1080p Engine step on the card: the demo shades every regen
    iteration in a kernel, so ``_shade_torch.iterations`` stays put; so
    does the mid grid, whose kernel 3 winners ``regen_shade_lite``
    shades."""
    from gdpathtracing_torch import Engine
    from gdpathtracing_torch.render import regen
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    if where == "demo":
        scene, cam = build_demo_scene(), demo_camera(1920, 1080)
    else:
        scene = build_sphere_grid(n=4, sphere_detail=12)
        cam = grid_camera(1920, 1080, n=4)
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=5, spp=1,
                       nee=False, rr_start=0)
    engine = Engine(scene, cfg)
    before, it0 = regen._shade_torch.iterations, \
        regen.render_radiance_regen.iterations
    engine.step(cam)
    torch.cuda.synchronize()
    iters = regen.render_radiance_regen.iterations - it0
    assert iters > 0
    assert regen._shade_torch.iterations - before == 0


def _lite_shade_inputs(prep, nw, bounces, seed):
    """One regen iteration's inputs on the bench grid: kernel 3's raw
    winners of random rays inside the grid's box, 15% of them outside it
    heading away (misses), and random lane stacks as
    :func:`_shade_inputs` makes them (bounces up to the cap, 15% of the
    lanes inactive)."""
    from gdpathtracing_torch.core.vec import Vec3
    from gdpathtracing_torch.render.types import Ray
    g = np.random.default_rng(seed)
    cb = prep.bounds.cpu().numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo, hi, (nw, 3)).T
    d = g.normal(size=(3, nw))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    out = g.uniform(size=nw) < 0.15
    o[:, out] = (hi + 1.0)[:, None]
    d[:, out] = np.abs(d[:, out])

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    active = torch.from_numpy(g.uniform(size=nw) < 0.85).cuda()
    o, d = f32(o), f32(d)
    lite = ti.sc_lite_winners(Ray(Vec3(*o), Vec3(*d)), active, prep)
    fs = torch.cat([o, d, f32(g.uniform(0.0, 1.5, (3, nw))),
                    f32(g.uniform(0.0, 2.0, (3, nw))),
                    f32(g.uniform(-1.0, 3.0, (1, nw))),
                    f32(g.uniform(0.0, 1000.0, (1, nw))),
                    f32(g.normal(size=(3, nw)))])
    ints = torch.from_numpy(np.stack(
        [g.integers(0, 1 << 32, nw), g.integers(0, 1 << 32, nw),
         g.permutation(nw), g.integers(0, bounces, nw),
         g.integers(0, 1 << 20, nw), g.integers(0, bounces, nw)])).cuda()
    return lite, fs, ints, active


@pytest.mark.parametrize("case", ["full", "drained"])
def test_regen_shade_lite_kernel_matches_torch(case):
    """``regen_shade_lite`` against its plain version (``lite_epilogue``,
    then regen's torch body) on the card, on kernel 3's winners over the
    bench grid with misses, emissive and metal hits, lanes at the bounce
    cap and inactive lanes: 393216 lanes (the 1080p wavefront), and the
    first 5120 lanes of 8192-wide stacks (a drain stage's first
    iteration) under another sky, ray_eps and bounce count. Every output
    row bit for bit, the masks and the two counts equal."""
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.scene.demo import build_sphere_grid
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_sphere_grid(n=10, sphere_detail=16)
    prep = ti.prepare_trace_inputs(scene)
    assert ti._sc_lite_fits(prep)
    if case == "full":
        cfg, nw, size = RenderConfig(traversal=Traversal.PALLAS), 393216, \
            393216
    else:
        cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=3,
                           ray_eps=3e-3, sky_horizon=(0.3, 0.5, 0.7),
                           sky_zenith=(0.1, 0.2, 1.3))
        nw, size = 8192, 5120
    lite, fs, ints, active = _lite_shade_inputs(prep, nw, cfg.bounces, 7)
    lite, fs, ints, active = (lite[:, :size], fs[:, :size], ints[:, :size],
                              active[:size])
    tables = shade.lite_tables(scene)
    cols, rows16, mats = tables
    hit = active & (lite[0] < ti._MISS)
    mat = mats[rows16[torch.where(hit, lite[1].long(), 0), 15].long()]
    for kind in (active & ~hit, hit & (mat[:, 6] > 0.0),
                 hit & (mat[:, 7] > 0.5), active & (ints[3] == cfg.bounces - 1),
                 hit & (ints[3] == 0), ~active):
        assert kind.any()
    before = shade.regen_shade_lite.launches
    got = shade.regen_shade_lite(scene, prep, lite, fs, ints, active, cfg,
                                 tables)
    torch.cuda.synchronize()
    assert shade.regen_shade_lite.launches == before + 1
    want = shade.regen_shade_lite_plain(scene, prep, lite, fs, ints, active,
                                        cfg)
    assert got[0].shape == want[0].shape == (17, size)
    for r in range(17):
        assert torch.equal(got[0][r].view(torch.int32),
                           want[0][r].view(torch.int32)), f"fs row {r}"
    for r in range(6):
        assert torch.equal(got[1][r], want[1][r]), f"ints row {r}"
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert got[4].tolist() == want[4].tolist()
    assert 0 < got[4][0] < size and 0 < got[4][1] < size


@pytest.mark.parametrize("retire", ["log", "scatter"])
def test_regen_shade_lite_frame_matches_torch(retire, monkeypatch):
    """A 320x180 frame of the mid grid through regen with 16384 lanes (two
    drain stages) shades in ``regen_shade_lite``, one launch an
    iteration, and equals bit for bit the frame with every iteration in
    the torch body (kernel 3, ``lite_epilogue`` and the torch body)."""
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.render import regen
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_sphere_grid(n=4, sphere_detail=12)
    cam = grid_camera(320, 180, n=4)
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen_wavefront=16384,
                       regen_retire=retire)
    assert shade.shade_entry(scene, cfg, ti.prepare_trace_inputs(scene),
                             False, False) == "lite"
    before, rows0 = shade.regen_shade_lite.launches, shade.regen_shade.launches
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 3)
    torch.cuda.synchronize()
    iters = regen.render_radiance_regen.iterations
    assert shade.regen_shade_lite.launches - before == iters > 5
    assert shade.regen_shade.launches == rows0
    monkeypatch.setattr(regen, "shade_entry", lambda *a: None)
    want = render_radiance(scene, cam, cfg, 3)
    assert shade.regen_shade_lite.launches - before == iters
    for k in ("radiance", "depth", "normal", "steps", "segments"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.device.type == "cuda"
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("where", ["grid", "demo"])
def test_regen_shade_entry_launch_counts(where):
    """One 1080p Engine step of the benchmark's grid (n=10, 5 bounces)
    shades its 15 regen iterations in ``regen_shade_lite``: 15 launches,
    no torch shading iteration and no ``trace_epilogue``; the demo's step
    still makes 9 ``regen_shade`` launches and no lite launch."""
    from gdpathtracing_torch import Engine
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.render import regen
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    from gdpathtracing_torch.utils.telemetry import SPANS
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    if where == "grid":
        scene = build_sphere_grid(n=10, sphere_detail=16)
        cam, iters = grid_camera(1920, 1080, n=10), 15
    else:
        scene, cam, iters = build_demo_scene(), demo_camera(1920, 1080), 9
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=5, spp=1,
                       nee=False, rr_start=0)
    engine = Engine(scene, cfg)
    before = (shade.regen_shade_lite.launches, shade.regen_shade.launches,
              regen._shade_torch.iterations,
              regen.render_radiance_regen.iterations,
              SPANS.trace_epilogue.count)
    engine.step(cam)
    torch.cuda.synchronize()
    after = (shade.regen_shade_lite.launches, shade.regen_shade.launches,
             regen._shade_torch.iterations,
             regen.render_radiance_regen.iterations,
             SPANS.trace_epilogue.count)
    lite, rows, torch_it, it, epi = (a - b for a, b in zip(after, before))
    assert it == iters
    assert (lite, rows) == ((iters, 0) if where == "grid" else (0, iters))
    assert torch_it == 0 and epi == 0


def _lane_inputs(scene, nw, seed):
    """One regen iteration's lane state after the shading, on the card:
    origins inside the scene's box (5% of them outside it, a quarter of
    those NaN-free far out), random directions, 60% of the lanes alive,
    15% ended now, the rest dead before; random throughput, radiance,
    AOVs, PCG2D words, path ids, bounces, steps (some above the log's
    2^19 - 1) and segments."""
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.cpu().numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo, hi, (nw, 3)).T
    out = g.uniform(size=nw) < 0.05
    o[:, out] = g.uniform(lo - 50.0, hi + 50.0, (int(out.sum()), 3)).T
    d = g.normal(size=(3, nw))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    u = g.uniform(size=nw)
    alive, dead_now = u < 0.6, (u >= 0.6) & (u < 0.75)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    fs = torch.cat([f32(o), f32(d), f32(g.uniform(0.0, 1.5, (6, nw))),
                    f32(g.uniform(-1.0, 3.0, (1, nw))),
                    f32(g.uniform(0.0, 1000.0, (1, nw))),
                    f32(g.normal(size=(3, nw)))])
    ints = torch.from_numpy(np.stack(
        [g.integers(0, 1 << 32, nw), g.integers(0, 1 << 32, nw),
         g.permutation(nw), g.integers(0, 5, nw),
         g.integers(0, 1 << 20, nw), g.integers(0, 5, nw)])).cuda()
    return (fs, ints, torch.from_numpy(alive).cuda(),
            torch.from_numpy(dead_now).cuda())


# (scene, jitter, case, spp, frame index): the demo under every jitter
# mode; a refill with paths for every dead lane, one that runs out half
# way, and a drain stage's (the first 5120 lanes of 8192-wide stacks);
# frame indices whose frame_index * spp passes 2^32.
LANE_CASES = {
    "demo_uniform": ("demo", "UNIFORM", "full", 1, 3),
    "demo_none": ("demo", "NONE", "full", 1, 2 ** 32 - 1),
    "demo_gauss": ("demo", "GAUSS", "full", 2, 2 ** 31 + 7),
    "demo_circle": ("demo", "CIRCLE", "full", 1, 12345),
    "demo_runs_out": ("demo", "UNIFORM", "runs_out", 2, 2 ** 32 - 2),
    "demo_drain": ("demo", "GAUSS", "drain", 1, 41),
    "grid_uniform": ("grid", "UNIFORM", "full", 1, 2 ** 32 + 5),
    "grid_runs_out": ("grid", "UNIFORM", "runs_out", 1, 9),
    "grid_drain": ("grid", "UNIFORM", "drain", 2, 2 ** 31),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_regen_lanes_kernels_match_plain(case):
    """``regen_lane_key`` and ``regen_lane_refill`` against their plain
    versions (regen's torch glue) on the card, on one iteration's lane
    state of 393216 lanes (the 1080p wavefront) or a drain stage's 5120,
    with the 1080p demo or bench-grid camera: the key, the permuted and
    refilled stacks, the active mask and every log column bit for bit,
    one launch each."""
    from gdpathtracing_torch.config import Jitter
    from gdpathtracing_torch.ops import lanes
    from gdpathtracing_torch.render.integrator import morton_frame
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    where, jitter, kind, spp, frame = LANE_CASES[case]
    if where == "demo":
        scene, cam = build_demo_scene(), demo_camera(1920, 1080)
    else:
        scene, cam = build_sphere_grid(n=10, sphere_detail=16), \
            grid_camera(1920, 1080, n=10)
    cfg = RenderConfig(traversal=Traversal.PALLAS, spp=spp,
                       jitter=Jitter[jitter])
    sp = lanes.lane_spawn(cam.to("cuda"), cfg, frame)
    nw, size = (8192, 5120) if kind == "drain" else (393216, 393216)
    fs, ints, alive, dead_now = (x[..., :size] for x in
                                 _lane_inputs(scene, nw, 11))
    lo, span = morton_frame(scene)
    k0 = lanes.regen_lane_key.launches
    key = lanes.regen_lane_key(fs, alive, dead_now, lo, span)
    torch.cuda.synchronize()
    assert lanes.regen_lane_key.launches == k0 + 1
    want_key = lanes.regen_lane_key_plain(fs, alive, dead_now, lo, span)
    assert key.dtype == want_key.dtype == torch.int32
    assert torch.equal(key, want_key)
    assert len(torch.unique(key[alive])) > 64
    perm = torch.argsort(key, stable=True)
    # The refill takes the shading's (NF, size) output; a drain stage's
    # starts from a view of the wider stacks, which the key reads above.
    fs, ints = fs.contiguous(), ints.contiguous()
    n_alive, n_fresh = int(alive.sum()), int(dead_now.sum())
    n_paths = 1920 * 1080 * spp
    next_path = {"full": 1000, "runs_out": n_paths - (size - n_alive) // 2,
                 "drain": n_paths - 17}[kind]
    cols = n_paths + nw
    g = torch.Generator(device="cuda").manual_seed(3)
    log_f = torch.rand((7, cols), device="cuda", generator=g)
    log_i = torch.randint(0, 1 << 40, (3, cols), device="cuda", generator=g)
    retired = n_paths - n_fresh - 5
    logs = [(log_f.clone(), log_i.clone()) for _ in range(2)]
    r0 = lanes.regen_lane_refill.launches
    got = lanes.regen_lane_refill(perm, fs, ints, *logs[0], n_alive, n_fresh,
                                  retired, next_path, sp)
    torch.cuda.synchronize()
    assert lanes.regen_lane_refill.launches == r0 + 1
    want = lanes.regen_lane_refill_plain(perm, fs, ints, *logs[1], n_alive,
                                         n_fresh, retired, next_path, sp)
    for r in range(17):
        assert torch.equal(got[0][r].view(torch.int32),
                           want[0][r].view(torch.int32)), f"fs row {r}"
    for r in range(6):
        assert torch.equal(got[1][r], want[1][r]), f"ints row {r}"
    assert torch.equal(got[2], want[2])
    assert torch.equal(logs[0][0].view(torch.int32),
                       logs[1][0].view(torch.int32))
    assert torch.equal(logs[0][1], logs[1][1])
    refilled = int(got[2].sum()) - n_alive
    assert refilled == min(size - n_alive, n_paths - next_path) > 0
    assert not torch.equal(logs[0][1], log_i)


@pytest.mark.parametrize("change", ["demo", "mid", "demo_spp2_gauss",
                                    "demo_nee", "demo_circle"])
def test_regen_lanes_frame_matches_torch_glue(change, monkeypatch):
    """A 320x180 frame through regen with 16384 lanes (two drain stages)
    runs the lanes' two kernels once an iteration and equals bit for bit
    the frame of regen's torch glue (``lanes_entry`` False): the demo, the
    mid grid, the demo at 2 spp with Gaussian jitter, with unfused NEE
    (shaded in the torch body) and with the circle jitter."""
    from gdpathtracing_torch.config import Jitter
    from gdpathtracing_torch.ops import lanes
    from gdpathtracing_torch.render import regen
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    if change == "mid":
        scene, cam = build_sphere_grid(n=4, sphere_detail=12), \
            grid_camera(320, 180, n=4)
    else:
        scene = build_demo_scene(texture_resolution=8, sphere_detail=6)
        cam = demo_camera(320, 180)
    extra = {"demo_spp2_gauss": {"spp": 2, "jitter": Jitter.GAUSS},
             "demo_nee": {"nee": True},
             "demo_circle": {"jitter": Jitter.CIRCLE}}.get(change, {})
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen_wavefront=16384,
                       **extra)
    before = (lanes.regen_lane_key.launches, lanes.regen_lane_refill.launches)
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 2 ** 32 - 1)
    torch.cuda.synchronize()
    iters = regen.render_radiance_regen.iterations
    after = (lanes.regen_lane_key.launches, lanes.regen_lane_refill.launches)
    assert [a - b for a, b in zip(after, before)] == [iters, iters]
    assert iters > 5
    monkeypatch.setattr(regen, "lanes_entry", lambda *a: False)
    want = render_radiance(scene, cam, cfg, 2 ** 32 - 1)
    assert lanes.regen_lane_refill.launches == after[1]
    for k in ("radiance", "depth", "normal", "steps", "segments"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.device.type == "cuda"
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("where", ["demo", "grid", "mid_march",
                                   "demo_fused_nee"])
def test_regen_lanes_launch_counts(where):
    """One 1080p Engine step of the benchmark's demo and grid launches
    each lane kernel once a regen iteration (9 and 15 times); a march
    frame of the mid grid and a fused-NEE frame of the demo keep the
    torch glue and launch neither."""
    from gdpathtracing_torch import Engine
    from gdpathtracing_torch.ops import lanes
    from gdpathtracing_torch.render import regen
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=5, spp=1,
                       nee=False, rr_start=0)
    if where == "grid":
        scene, cam = build_sphere_grid(n=10, sphere_detail=16), \
            grid_camera(1920, 1080, n=10)
    elif where == "mid_march":
        scene, cam = build_sphere_grid(n=4, sphere_detail=12), \
            grid_camera(1920, 1080, n=4)
        cfg = cfg.replace(regen_march=True)
    else:
        scene, cam = build_demo_scene(), demo_camera(1920, 1080)
        if where == "demo_fused_nee":
            cfg = cfg.replace(nee=True, regen_fuse_nee=True)
    before = (lanes.regen_lane_key.launches, lanes.regen_lane_refill.launches,
              regen.render_radiance_regen.iterations)
    if where in ("demo", "grid"):
        Engine(scene, cfg).step(cam)
    else:
        render_radiance(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    key, refill, iters = (a - b for a, b in zip(
        (lanes.regen_lane_key.launches, lanes.regen_lane_refill.launches,
         regen.render_radiance_regen.iterations), before))
    want = {"demo": 9, "grid": 15}.get(where, 0)
    assert iters > 0
    assert key == refill == want
    if want:
        assert iters == want


# ---- the primal BVH loop's shading kernel (csrc/path_shade.cu) ------------

def _bvh_carry_inputs(scene, n, bounces, seed):
    """One bounce's hit and carry on the card: rays from inside the demo
    room, 15% of them outside it heading away (misses) and 10% outside it
    heading for its middle (back faces of the walls), traced by
    ``trace_bvh``; random throughput, radiance, prev pdf, depth, first-hit
    normal, PCG2D words, steps and segments; 15% of the lanes inactive."""
    from gdpathtracing_torch.core.vec import Vec3
    from gdpathtracing_torch.render.traverse import trace_bvh
    from gdpathtracing_torch.render.types import Ray
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.cpu().numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    mid = 0.5 * (lo + hi)
    o = g.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).T
    d = g.normal(size=(3, n))
    u = g.uniform(size=n)
    away, inward = u < 0.15, (u >= 0.15) & (u < 0.25)
    o[:, away] = (hi + 1.0)[:, None]
    d[:, away] = np.abs(d[:, away])
    far_o = mid[:, None] + 2.0 * (hi - lo)[:, None] * np.sign(
        g.normal(size=(3, int(inward.sum()))))
    o[:, inward] = far_o
    d[:, inward] = mid[:, None] - far_o + g.normal(
        scale=0.2, size=far_o.shape)
    d /= np.linalg.norm(d, axis=0, keepdims=True)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    o, d = f32(o), f32(d)
    active = torch.from_numpy(g.uniform(size=n) < 0.85).cuda()
    hit = trace_bvh(scene, Ray(Vec3(*o), Vec3(*d)), active)
    fs = torch.cat([o, d, f32(g.uniform(0.0, 1.5, (3, n))),
                    f32(g.uniform(0.0, 2.0, (3, n))),
                    f32(g.uniform(-1.0, 3.0, (1, n))),
                    f32(g.uniform(0.0, 1000.0, (1, n))),
                    f32(g.normal(size=(3, n)))])
    seeds = torch.from_numpy(g.integers(0, 1 << 32, (2, n))).cuda()
    counts = torch.from_numpy(np.stack([
        g.integers(0, 1 << 20, n), g.integers(0, bounces, n)]).astype(
            np.int32)).cuda()
    return hit, fs, seeds, counts, active


@pytest.mark.parametrize("case", ["bounce 0", "bounce 3", "small"])
def test_path_shade_bvh_kernel_matches_plain(case):
    """``path_shade_bvh`` against its plain version (the standard loop's
    torch body) on the card, on one bounce's carry with inactive lanes,
    misses, back faces and emissive and mirror hits: 262144 lanes (a 1080p
    tile) at bounce 0 under ``RenderConfig()``, at bounce 3 under another
    sky and ray_eps, and 1000 lanes (a ragged last block). Every carry
    row bit for bit, one launch."""
    from gdpathtracing_torch.ops import shade
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6)
    cfg, bounce, n = RenderConfig(), 0, 262144
    if case == "bounce 3":
        cfg, bounce = RenderConfig(ray_eps=3e-3, sky_horizon=(0.3, 0.5, 0.7),
                                   sky_zenith=(0.1, 0.2, 1.3)), 3
    elif case == "small":
        bounce, n = 1, 1000
    hit, fs, seeds, counts, active = _bvh_carry_inputs(scene, n, cfg.bounces,
                                                       7)
    won = hit.hit & active
    mats = scene.inst_materials[hit.inst.long(), torch.clamp(
        scene.tri_slot[hit.tri.long()].long(),
        max=scene.inst_materials.shape[1] - 1)].long()
    kinds = [active & ~won, won & ~hit.front, won & hit.front, ~active]
    if case != "small":
        kinds += [won & (scene.mat_emission_energy[mats] > 0.0),
                  won & (scene.mat_metallic[mats] > 0.5)]
    for kind in kinds:
        assert kind.any()
    before = shade.path_shade_bvh.launches
    got = shade.path_shade_bvh(scene, hit, fs, seeds, counts, active, cfg,
                               bounce)
    torch.cuda.synchronize()
    assert shade.path_shade_bvh.launches == before + 1
    want = shade.path_shade_bvh_plain(scene, hit, fs, seeds, counts, active,
                                      cfg, bounce)
    for r in range(fs.shape[0]):
        assert torch.equal(got[0][r].view(torch.int32),
                           want[0][r].view(torch.int32)), f"fs row {r}"
    for k, name in ((1, "seeds"), (2, "counts"), (3, "active")):
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), name
    alive = int(got[3].sum())
    assert 0 < alive < int(won.sum())


@pytest.mark.parametrize("res", ["1080p", "64x48"])
def test_path_shade_bvh_frame_matches_torch(res, monkeypatch):
    """A ``RenderConfig()`` demo frame (1080p: 8 tiles of 262144 rays; and
    64x48) shades in the kernel, one launch a tile and bounce, and equals
    bit for bit the frame through the standard loop's torch body."""
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.render import integrator
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene()
    w, h = (1920, 1080) if res == "1080p" else (64, 48)
    cam, cfg = demo_camera(w, h), RenderConfig()
    tiles = -(-w * h // cfg.tile_rays)
    before = shade.path_shade_bvh.launches
    got = render_radiance(scene, cam, cfg, 5)
    torch.cuda.synchronize()
    assert shade.path_shade_bvh.launches - before == tiles * cfg.bounces
    monkeypatch.setattr(integrator, "path_shade_entry", lambda *a: None)
    want = render_radiance(scene, cam, cfg, 5)
    torch.cuda.synchronize()
    assert shade.path_shade_bvh.launches - before == tiles * cfg.bounces
    for k in ("radiance", "depth", "normal", "steps", "segments"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.device.type == "cuda" and a.dtype == b.dtype
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


def test_path_shade_bvh_launch_counts():
    """One 1080p Engine step under ``RenderConfig()`` (the benchmark's
    demo.bvh) launches the kernel 40 times (8 tiles x 5 bounces); a BVH
    frame with NEE, a regen frame and an inverse step launch it never."""
    from gdpathtracing_torch import Engine
    from gdpathtracing_torch.diff import inverse
    from gdpathtracing_torch.ops import shade
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    scene = build_demo_scene()
    before = shade.path_shade_bvh.launches
    Engine(scene, RenderConfig()).step(demo_camera(1920, 1080))
    torch.cuda.synchronize()
    assert shade.path_shade_bvh.launches - before == 40
    small = demo_camera(64, 48)
    pallas = RenderConfig(traversal=Traversal.PALLAS)
    before = shade.path_shade_bvh.launches
    render_radiance(scene, small, RenderConfig(nee=True), 0)
    target = render_radiance(scene, small, pallas, 0).radiance
    step = inverse.value_and_grad_step(
        inverse.replace_albedo, pallas.replace(differentiable=True))
    loss, grads = step(scene.mat_albedo * 0.5, scene, small, target, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and grads.shape == scene.mat_albedo.shape
    assert shade.path_shade_bvh.launches == before
