"""Regen's frontier march in the port (ops/intersect.py kernel 7
``march_step_sc`` with ``march_sweep``, the candidate scan
``march_next_candidates``, the block queues ``march_block_queue`` and the
gate ``march_supported``; render/regen.py's march branch) against the JAX
package, whose kernel runs in Pallas interpret mode:

- on the mid grid (``build_sphere_grid(n=4, sphere_detail=12)``, 5
  superchunks), 512 rays from a numpy seed: the candidate scan and the
  queues exactly; kernel 7's plain version from the spawn state, from a
  carried best, with sentinel and duplicate queue entries, and at an exact
  t tie with a larger carried eidx; a queue of every superchunk gives
  kernel 3's winners;
- one 40x24 march frame of ``build_sphere_grid(n=4)`` against JAX's;
- inside the port, bit for bit: march against no march (QL 1, 2, 4; NEE;
  the two-stage drain), the gate (a flat scene, rows over the resident
  threshold) and the regen options that fall back to the default frame.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.config import (RenderConfig as JRenderConfig,
                                      Traversal as JTraversal)
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.regen import (
    render_radiance_regen as jax_render_radiance_regen)
from gdpathtracing_tpu.scene.demo import (
    build_demo_scene as jax_demo_scene,
    build_sphere_grid as jax_sphere_grid, grid_camera as jax_grid_camera)

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render.regen import render_radiance_regen
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import MISS_T
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
N, K, QL = 512, 6, 8
W, H = 40, 24
BASE = RenderConfig(traversal=Traversal.PALLAS, bounces=3, regen=True)
AOVS = ("radiance", "depth", "segments", "normal")
# t of kernel 7 against JAX's: the K=4 matmul of JAX's superchunk sweep
# (tests/test_torch_superchunk.py); the winners (eidx) are equal.
T_RTOL, T_ATOL = 1e-6, 5e-6
# Whole grid frames against JAX: the lite path's shading normals come from
# other sums than JAX's, so radiance differs by up to ~2e-4 on a tenth of
# the pixels, no march needed (tests/test_torch_superchunk.py's frame
# tolerance); segments are equal on every pixel.
FRAME_ATOL, MIN_PIXELS_OK = 2e-3, 0.99


@pytest.fixture(scope="module")
def mid():
    js = jax_sphere_grid(n=4, sphere_detail=12)
    ts = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    return jip.prepare_trace_inputs(js), ti.prepare_trace_inputs(ts)


@pytest.fixture(scope="module")
def rays():
    """512 rays as numpy (3, N) o, d: the primary rays of a 16x12 grid
    camera, 256 random rays above the grid, 64 parked, shuffled."""
    pids = torch.arange(16 * 12)
    ray, _ = grid_camera(16, 12, n=4).generate_rays(
        pids, rng.prng_seed(pids % 16, pids // 16, 1), RenderConfig())
    g = np.random.default_rng(11)
    o = np.stack([g.uniform(-6, 6, 256), g.uniform(-0.5, 7.5, 256),
                  g.uniform(-6, 6, 256)]).astype(np.float32)
    d = g.normal(size=(3, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.concatenate([ray.o.to_array(0).numpy(), o,
                        np.full((3, 64), 1e9, np.float32)], axis=1)
    d = np.concatenate([ray.d.to_array(0).numpy(), d,
                        np.full((3, 64), 0.5773503, np.float32)], axis=1)
    perm = g.permutation(N)
    return np.ascontiguousarray(o[:, perm]), np.ascontiguousarray(d[:, perm])


def _state(seed):
    """A march state for 512 lanes: a tenth dead, half the cursors at the
    start (-inf, -1), half the running bests none (1e9)."""
    g = np.random.default_rng(seed)
    alive = g.uniform(size=N) > 0.1
    start = g.uniform(size=N) < 0.5
    m_t = np.where(start, -np.inf, g.uniform(0, 6, N)).astype(np.float32)
    m_sc = np.where(start, -1, g.integers(0, 5, N))
    b_t = np.where(g.uniform(size=N) < 0.5, 1e9,
                   g.uniform(2, 14, N)).astype(np.float32)
    return alive, m_t, m_sc, b_t


def _candidates(mid, rays, state, k):
    jp, tp = mid
    o, d = rays
    alive, m_t, m_sc, b_t = state
    jes, jss = jip.march_next_candidates(
        jp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)),
        jnp.asarray(alive), jnp.asarray(m_t),
        jnp.asarray(m_sc.astype(np.int32)), jnp.asarray(b_t), k=k)
    tes, tss = ti.march_next_candidates(
        tp, Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy, d)),
        torch.from_numpy(alive), torch.from_numpy(m_t),
        torch.from_numpy(m_sc.astype(np.int64)), torch.from_numpy(b_t), k=k)
    return jes, jss, tes, tss


@pytest.mark.parametrize("k", [1, 3, 6])
def test_march_next_candidates_matches_jax(mid, rays, k):
    jes, jss, tes, tss = _candidates(mid, rays, _state(1), k)
    assert len(tes) == len(tss) == k
    for i in range(k):
        np.testing.assert_array_equal(tes[i].numpy(), np.asarray(jes[i]))
        np.testing.assert_array_equal(tss[i].numpy(), np.asarray(jss[i]))
    found = tss[0].numpy() < 5
    assert 200 < found.sum() < N  # candidates, and lanes with none
    assert (tes[0].numpy()[~found] == np.inf).all()


def _sorted_columns(mid, rays, state):
    """The candidate columns of lanes sorted by their first two, as regen's
    march key sorts them: blocks with runs, sentinels and repeats."""
    _, _, tes, tss = _candidates(mid, rays, state, K)
    order = np.lexsort((tss[1].numpy(), tss[0].numpy()))
    return [s.numpy()[order] for s in tss], order


@pytest.mark.parametrize("ql", [1, 2, 8])
def test_march_block_queue_matches_jax(mid, rays, ql):
    cols, _ = _sorted_columns(mid, rays, _state(2))
    jq, jok = jip.march_block_queue([jnp.asarray(c.astype(np.int32))
                                     for c in cols], 5, ql)
    tq, tok = ti.march_block_queue([torch.from_numpy(c) for c in cols], 5,
                                   ql)
    assert tq.dtype == torch.int32 and tq.shape == (N // ti.BN * ql,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    if ql == 8:  # deeper levels fill slots, sentinels pad the rest
        assert (tq.numpy() == 5).any() and (tq.numpy() < 5).sum() > 2


def _march_inputs(mid, rays, case):
    """(o4, d4, init for the port, init for JAX, queue) of one round."""
    jp, tp = mid
    o, d = rays
    o4 = np.concatenate([o, np.ones((1, N), np.float32)])
    d4 = np.concatenate([d, np.zeros((1, N), np.float32)])
    none = np.stack([np.full(N, 1e9, np.float32),
                     np.full(N, ti.BIG_E, np.float32)])
    cols, order = _sorted_columns(mid, rays, _state(3))
    o4, d4 = np.ascontiguousarray(o4[:, order]), np.ascontiguousarray(
        d4[:, order])
    queue = ti.march_block_queue([torch.from_numpy(c) for c in cols], 5,
                                 QL)[0].numpy()
    if case == "spawn":
        return o4, d4, none, none, queue
    if case == "sentinels":  # duplicates and out-of-range entries
        g = np.random.default_rng(4)
        queue = g.choice([0, 1, 2, 3, 4, 5, 9, 2, 2], size=queue.shape)
        return o4, d4, none, none, queue.astype(np.int32)
    first = ti.march_step_sc_plain(*_port_ops(tp, o4, d4, none, queue))
    if case == "carried":  # the second round, from the first's best
        init = first[:2].numpy()
        return o4, d4, init, init, ti.march_block_queue(
            [torch.from_numpy(c) for c in cols[1:]], 5, QL)[0].numpy()
    # "tie": each framework's own first-round winner carried at the same
    # t with a larger eidx; a miss carries (1e9, BIG_E)
    jfirst = _jax_march(jp, o4, d4, none, queue)
    tie_p, tie_j = first[:2].numpy().copy(), jfirst[:2].copy()
    for x in (tie_p, tie_j):
        x[1] = np.where(x[0] < MISS_T, x[1] + 7, ti.BIG_E)
    return o4, d4, tie_p, tie_j, queue


def _port_ops(tp, o4, d4, init, queue):
    return (torch.from_numpy(o4), torch.from_numpy(d4),
            torch.from_numpy(np.ascontiguousarray(init)),
            torch.from_numpy(queue), tp.sc_bounds, tp.chunk_bounds,
            tp.mu_pad, tp.mv_pad, tp.mw_pad, tp.scc)


def _jax_march(jp, o4, d4, init, queue):
    return np.asarray(jip._march_step_sc(
        jnp.asarray(o4), jnp.asarray(d4), jnp.asarray(init),
        jnp.asarray(queue), jp.sc_flat, jp.chunk_flat, jp.m3, scc=jp.scc,
        nsc=jp.sc_flat.shape[0] // 8, interpret=True))


@pytest.mark.parametrize("case", ["spawn", "carried", "sentinels", "tie"])
def test_march_step_plain_matches_jax(mid, rays, case):
    jp, tp = mid
    o4, d4, init_p, init_j, queue = _march_inputs(mid, rays, case)
    want = _jax_march(jp, o4, d4, init_j, queue)
    before = ti.march_step_sc.launches
    got = ti.march_step_sc(*_port_ops(tp, o4, d4, init_p, queue)).numpy()
    assert ti.march_step_sc.launches == before  # the plain version
    assert got.shape == want.shape == (ti.LITE_R, N)
    hit = want[0] < MISS_T
    assert hit.sum() > 100
    np.testing.assert_allclose(got[0], want[0], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][~hit] == ti.BIG_E).all()  # none carried, none found
    assert (got[4:] == 0).all()
    parked = o4[0] > 1e8
    assert (got[2][parked] == 0).all() and (got[2] % ti.BT == 0).all()
    if case == "tie":  # the lower eidx of the sweep wins the exact tie
        np.testing.assert_array_equal(got[1][hit], init_p[1][hit] - 7)
        np.testing.assert_array_equal(got[0], init_p[0])


def test_march_full_queue_equals_kernel_3(mid, rays):
    """A round whose queue lists every superchunk, from no winner, is
    kernel 3's walk: the same rows, with BIG_E for a miss's eidx."""
    _, tp = mid
    o, d = rays
    o4 = torch.from_numpy(np.concatenate([o, np.ones((1, N), np.float32)]))
    d4 = torch.from_numpy(np.concatenate([d, np.zeros((1, N), np.float32)]))
    init = torch.stack([torch.full((N,), 1e9), torch.full((N,),
                                                          float(ti.BIG_E))])
    queue = torch.arange(5, dtype=torch.int32).repeat(N // ti.BN)
    got = ti.march_step_sc(o4, d4, init, queue, tp.sc_bounds,
                           tp.chunk_bounds, tp.mu_pad, tp.mv_pad, tp.mw_pad,
                           tp.scc)
    want = ti.closest_hit_sc_lite(o4, d4, tp.sc_bounds, tp.chunk_bounds,
                                  tp.group_bounds, tp.mu_pad, tp.mv_pad,
                                  tp.mw_pad, tp.scc)
    hit = want[0] < MISS_T
    assert torch.equal(got[[0, 2, 3]], want[[0, 2, 3]])
    assert torch.equal(got[1][hit], want[1][hit])
    with pytest.raises(ValueError, match="queue"):
        ti.march_step_sc(o4, d4, init, queue[:7], tp.sc_bounds,
                         tp.chunk_bounds, tp.mu_pad, tp.mv_pad, tp.mw_pad,
                         tp.scc)


def test_march_supported_matches_jax(mid, monkeypatch):
    jp, tp = mid
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          device="cpu")
    assert ti.march_supported(tp) and jip.march_supported(None, jp)
    assert not ti.march_supported(ti.prepare_trace_inputs(ts))
    assert not jip.march_supported(js, jip.prepare_trace_inputs(js))
    monkeypatch.setattr(ti, "_SC_RESIDENT_BYTES", 1 << 16)
    monkeypatch.setattr(jip, "_SC_RESIDENT_BYTES", 1 << 16)
    assert not ti.march_supported(tp) and not jip.march_supported(None, jp)


@pytest.fixture(scope="module")
def grid():
    return build_sphere_grid(n=4, device="cpu"), grid_camera(W, H, n=4)


@pytest.fixture(scope="module")
def no_march(grid):
    return render_radiance(grid[0], grid[1], BASE, 3)


def _assert_frames_equal(a, b):
    for k in AOVS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_march_render_matches_jax(grid, no_march):
    """JAX regen with the march (interpret mode) at 40x24, 3 bounces,
    frame 3, against the port's march frame, which equals its no-march
    frame bit for bit, in as many iterations and lane slots as JAX's (the
    march's advance, rescans, sort key and re-queues change those, not the
    frame), with the same live lanes in every iteration."""
    cfg_j = JRenderConfig(bounces=3, traversal=JTraversal.PALLAS, regen=True,
                          regen_march=True)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref, ref_stats = jax_render_radiance_regen(
            jax_sphere_grid(n=4), jax_grid_camera(W, H, n=4), cfg_j, 3,
            return_stats=True)
    finally:
        jip._FORCE_INTERPRET = old
    got, stats = render_radiance_regen(grid[0], grid[1],
                                       BASE.replace(regen_march=True), 3,
                                       return_stats=True)
    assert stats["iters"] == int(ref_stats["iters"])
    assert stats["lane_slots"] == int(ref_stats["lane_slots"])
    np.testing.assert_array_equal(stats["it_alive"].numpy(),
                                  np.asarray(ref_stats["it_alive"]))
    _assert_frames_equal(got, no_march)
    ok = (np.abs(got.radiance.numpy() - np.asarray(ref.radiance))
          <= FRAME_ATOL).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy(),
                                  np.asarray(ref.segments))
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], rtol=1e-5)


@pytest.mark.parametrize("ql", [1, 2, 4])
def test_march_matches_no_march(grid, no_march, ql, monkeypatch):
    """tests/test_regen.py's march oracle inside the port: bit for bit at
    every queue length, in more iterations than without the march, each
    one march round."""
    calls = []
    plain = ti.march_step_sc_plain
    monkeypatch.setattr(ti, "march_step_sc_plain",
                        lambda *a: calls.append(1) or plain(*a))
    render_radiance_regen.iterations = 0
    got = render_radiance(grid[0], grid[1],
                          BASE.replace(regen_march=True, regen_march_ql=ql),
                          3)
    _assert_frames_equal(got, no_march)
    assert len(calls) == render_radiance_regen.iterations > 3


def test_march_nee_matches_no_march(grid):
    cfg = BASE.replace(nee=True)
    _assert_frames_equal(
        render_radiance(grid[0], grid[1], cfg.replace(regen_march=True), 2),
        render_radiance(grid[0], grid[1], cfg, 2))


def test_march_two_stage_drain(grid):
    """Drain and march together (tests/test_regen.py's grid configuration):
    the drain stages re-queue from their prefix and change no bit."""
    cfg = BASE.replace(regen_march=True, regen_wavefront=512)
    render_radiance_regen.iterations = 0
    _, stats = render_radiance_regen(
        grid[0], grid[1], cfg.replace(regen_drain=True,
                                      regen_drain_wavefront=256), 2,
        return_stats=True)
    assert stats["lane_slots"] < 512 * stats["iters"]  # a drain stage ran
    _assert_frames_equal(
        render_radiance(grid[0], grid[1],
                        cfg.replace(regen_drain=True,
                                    regen_drain_wavefront=256), 2),
        render_radiance(grid[0], grid[1], cfg.replace(regen_drain=False), 2))


@pytest.mark.parametrize("where", ["demo", "over_threshold"])
def test_march_gate_renders_without_it(where, monkeypatch):
    """Where march_supported is false, regen_march=True renders the frame
    without it, through kernel 1 or 3 (6 here), as the reference does."""
    calls = []
    plain = ti.march_step_sc_plain
    monkeypatch.setattr(ti, "march_step_sc_plain",
                        lambda *a: calls.append(1) or plain(*a))
    if where == "demo":
        scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                                 device="cpu")
        cam = demo_camera(24, 16)
    else:
        monkeypatch.setattr(ti, "_SC_RESIDENT_BYTES", 1 << 16)
        scene = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
        cam = grid_camera(24, 16, n=4)
    _assert_frames_equal(
        render_radiance(scene, cam, BASE.replace(regen_march=True), 1),
        render_radiance(scene, cam, BASE, 1))
    assert not calls


@pytest.mark.parametrize("option", ["fuse_nee_superchunk", "chunk_unsorted",
                                    "chunk_no_compaction", "chunk_march"])
def test_regen_options_fall_back(option):
    """The regen options the reference ignores in these configurations
    render the frame without them: fused NEE on a superchunk scene, and
    the first-chunk sort key where lanes are not sorted or the march's key
    takes precedence."""
    if option == "fuse_nee_superchunk" or option == "chunk_march":
        scene = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
        cam = grid_camera(24, 16, n=4)
    else:
        scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                                 device="cpu")
        cam = demo_camera(24, 16)
    ref, change = {
        "fuse_nee_superchunk": (BASE.replace(nee=True),
                                dict(regen_fuse_nee=True)),
        "chunk_unsorted": (BASE.replace(sort_rays=False),
                           dict(regen_sort_key="chunk")),
        "chunk_no_compaction": (BASE.replace(compact_rays=False),
                                dict(regen_sort_key="chunk")),
        "chunk_march": (BASE.replace(regen_march=True),
                        dict(regen_sort_key="chunk"))}[option]
    _assert_frames_equal(render_radiance(scene, cam, ref.replace(**change),
                                         1),
                         render_radiance(scene, cam, ref, 1))
