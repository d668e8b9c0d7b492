"""Kernels 8 and 9 of the port (ops/intersect.py ``closest_hit_classic`` and
``closest_hit_loop``, the classic flat (t, idx) closest hit) and
``trace_pallas_classic`` against the JAX package's ``_closest_hit``,
``_closest_hit_loop`` and ``trace_pallas_classic`` in Pallas interpret
mode, through the plain versions:

- on the demo scene (8 chunks) and on the mid grid walked flat (34 chunks),
  512 rays from a numpy seed: random rays, camera rays and parked rays;
- a hand-built block that pins kernel 9's block gate: one ray's gate passes
  where its block's other rays' fail, and they sweep the chunk with it;
- ``trace_pallas_classic``'s whole HitInfo on 300 camera rays (not a
  multiple of 256), a fifth of them inactive;
- inside the port: kernel 8's winners against kernel 1's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import (
    build_demo_scene as jax_demo_scene,
    build_sphere_grid as jax_sphere_grid)

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
N = 512
# t: JAX's kernel 8 takes the 4-term dots as a K=4 HIGHEST matmul, which
# sums in another order than the port's left-to-right products (the pinned
# K=4-matmul divergence of the superchunk kernels); XLA's CPU fusion of
# kernel 9's broadcast form rounds differently too (measured: t bit-equal
# on 90% of the demo's random rays and 92% of the mid grid's, at most
# 2.9e-6 apart). The winners (idx) are equal on every ray.
T_RTOL, T_ATOL = 1e-6, 5e-6
# u, v carry t's absolute error times |u_d| (tests/test_torch_superchunk.py).
UV_ATOL = 3e-5


def _scene_pair(name):
    if name == "demo":
        return (jax_demo_scene(texture_resolution=8, sphere_detail=6),
                build_demo_scene(texture_resolution=8, sphere_detail=6,
                                 device="cpu"), demo_camera)
    return (jax_sphere_grid(n=4, sphere_detail=12),
            build_sphere_grid(n=4, sphere_detail=12, device="cpu"),
            lambda w, h: grid_camera(w, h, n=4))


@pytest.fixture(scope="module", params=["demo", "mid"])
def case(request):
    """(name, JAX scene, port scene, o4, d4): 512 rays, a seeded shuffle of
    the primary rays of a 16x12 camera, 256 random rays through the scene
    and 64 parked ones."""
    js, ts, cam = _scene_pair(request.param)
    lo = ts.isect_chunk_bounds[0:3].amin(dim=1).numpy()
    hi = ts.isect_chunk_bounds[3:6].amax(dim=1).numpy()
    pids = torch.arange(16 * 12)
    ray, _ = cam(16, 12).generate_rays(
        pids, rng.prng_seed(pids % 16, pids // 16, 1), RenderConfig())
    g = np.random.default_rng(7)
    o = g.uniform(lo[:, None], hi[:, None], (3, 256)).astype(np.float32)
    d = g.normal(size=(3, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.concatenate([ray.o.to_array(0).numpy(), o,
                        np.full((3, 64), 1e9, np.float32)], axis=1)
    d = np.concatenate([ray.d.to_array(0).numpy(), d,
                        np.full((3, 64), 0.5773503, np.float32)], axis=1)
    perm = g.permutation(N)
    o4 = np.concatenate([o[:, perm], np.ones((1, N), np.float32)])
    d4 = np.concatenate([d[:, perm], np.zeros((1, N), np.float32)])
    return (request.param, js, ts, np.ascontiguousarray(o4),
            np.ascontiguousarray(d4))


def _port_args(ts, o4, d4, bounds=None):
    cb = ts.isect_chunk_bounds if bounds is None else bounds
    return (torch.from_numpy(o4), torch.from_numpy(d4),
            torch.as_tensor(cb).contiguous(), ts.isect_mu.contiguous(),
            ts.isect_mv.contiguous(), ts.isect_mw.contiguous())


def _jax(fn, js, o4, d4, bounds=None):
    cb = js.isect_chunk_bounds if bounds is None else jnp.asarray(bounds)
    t, idx = fn(jnp.asarray(o4), jnp.asarray(d4), cb, js.isect_mu,
                js.isect_mv, js.isect_mw, interpret=True)
    return np.asarray(t), np.asarray(idx)


@pytest.mark.parametrize("kernel", ["classic", "loop"])
def test_plain_matches_jax(case, kernel):
    name, js, ts, o4, d4 = case
    port = ti.closest_hit_classic if kernel == "classic" \
        else ti.closest_hit_loop
    want_t, want_i = _jax(jip._closest_hit if kernel == "classic"
                          else jip._closest_hit_loop, js, o4, d4)
    before = port.launches
    t, idx = port(*_port_args(ts, o4, d4))
    assert port.launches == before  # the plain version
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    hit = want_t < MISS_T
    assert 200 < hit.sum() < N - 64, name
    np.testing.assert_allclose(t.numpy(), want_t, rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    assert (t.numpy()[~hit] == MISS_T).all() and (idx.numpy()[~hit] == 0).all()
    assert (idx.numpy()[o4[0] > 1e8] == 0).all()  # parked rays


def test_kernel_9_block_gate():
    """A hand-built pair of blocks: chunk c's box shrunk to a point box on
    the path of one ray of block 0. Kernel 8 sweeps c for that ray alone;
    kernel 9 for every ray of block 0 (and none of block 1), so block 0's
    other rays whose triangle lies in c find it there and nowhere else,
    as JAX's kernels do."""
    js, ts, cam = _scene_pair("demo")
    pids = torch.arange(2 * ti.BN) + 24 * 64  # the middle rows of 64x48
    ray, _ = cam(64, 48).generate_rays(
        pids, rng.prng_seed(pids % 64, pids // 64, 1), RenderConfig())
    o4, d4 = (x.numpy() for x in ti.pack_rays(ray))
    t, idx = ti.closest_hit_classic(*_port_args(ts, o4, d4))
    chunk = idx.numpy() // ti.BT
    hit = t.numpy() < MISS_T
    # The chunk most of block 0's rays hit, and one ray of it that does.
    c = int(np.bincount(chunk[:ti.BN][hit[:ti.BN]]).argmax())
    r0 = int(np.flatnonzero(hit[:ti.BN] & (chunk[:ti.BN] == c))[0])
    p = o4[:3, r0] + float(t[r0]) * d4[:3, r0]
    bounds = ts.isect_chunk_bounds.numpy().copy()
    bounds[0:3, c], bounds[3:6, c] = p - 1e-4, p + 1e-4
    args = _port_args(ts, o4, d4, bounds)
    t8, i8 = ti.closest_hit_classic(*args)
    t9, i9 = ti.closest_hit_loop(*args)
    in_c8, in_c9 = (i8.numpy() // ti.BT == c), (i9.numpy() // ti.BT == c)
    in_c8 &= t8.numpy() < MISS_T
    in_c9 &= t9.numpy() < MISS_T
    # Kernel 8: only the rays whose own gate passes (r0 among them).
    assert in_c8[r0] and in_c8.sum() < 8
    # Kernel 9: r0's block takes c wherever its own triangle lies there ...
    assert in_c9[:ti.BN].sum() > 4 * in_c8[:ti.BN].sum()
    np.testing.assert_array_equal(in_c9[:ti.BN],
                                  hit[:ti.BN] & (chunk[:ti.BN] == c))
    # ... and the other block, which no passing ray joins, does not.
    np.testing.assert_array_equal(in_c9[ti.BN:], in_c8[ti.BN:])
    for fn, (pt, pi) in ((jip._closest_hit, (t8, i8)),
                         (jip._closest_hit_loop, (t9, i9))):
        want_t, want_i = _jax(fn, js, o4, d4, bounds)
        np.testing.assert_allclose(pt.numpy(), want_t, rtol=T_RTOL,
                                   atol=T_ATOL)
        np.testing.assert_array_equal(pi.numpy(), want_i)


def test_trace_pallas_classic_matches_jax():
    js, ts, cam = _scene_pair("demo")
    n = 300
    pids = torch.arange(n) + 8 * 32
    ray, _ = cam(32, 24).generate_rays(
        pids, rng.prng_seed(pids % 32, pids // 32, 2), RenderConfig())
    active = np.random.default_rng(8).uniform(size=n) > 0.2
    o, d = ray.o.to_array(0).numpy(), ray.d.to_array(0).numpy()
    jip._FORCE_INTERPRET = True
    try:
        jh = jip.trace_pallas_classic(
            js, JRay(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d))),
            jnp.asarray(active), interpret=True)
    finally:
        jip._FORCE_INTERPRET = False
    th = ti.trace_pallas_classic(
        ts, Ray(Vec3(*map(torch.from_numpy, o)),
                Vec3(*map(torch.from_numpy, d))), torch.from_numpy(active))
    assert th.rows is None
    assert (np.asarray(jh.t) < MISS_T).sum() > n // 4
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=T_RTOL,
                               atol=T_ATOL)
    for f in ("tri", "inst", "front", "eidx", "steps"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), f)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)), atol=UV_ATOL)
    assert (th.steps == ts.isect_mu.shape[1]).all()
    assert (th.t[~torch.from_numpy(active)] == MISS_T).all()


def test_classic_winners_equal_kernel_1():
    """Kernel 8 (raw boxes, strict gate) finds kernel 1's winners
    (inflated boxes, lexicographic tie rule) on the demo's primary rays."""
    s = build_demo_scene(texture_resolution=8, sphere_detail=6, device="cpu")
    prep = ti.prepare_trace_inputs(s)
    pids = torch.arange(48 * 32)
    ray, _ = demo_camera(48, 32).generate_rays(
        pids, rng.prng_seed(pids % 48, pids // 48, 1), RenderConfig())
    h1 = ti.trace_pallas(s, ray, None, prep)
    h8 = ti.trace_pallas_classic(s, ray, None, prep)
    assert int(h1.hit.sum()) > 200
    assert torch.equal(h1.t, h8.t) and torch.equal(h1.eidx, h8.eidx)
    assert torch.equal(h1.tri, h8.tri)
    # front of a miss is w_d's sign against the row of eidx 0 (the
    # reference's epilogue); kernel 1's rows give False there.
    assert torch.equal(h1.front[h1.hit], h8.front[h1.hit])
    o4t, d4t = ti.pack_rays(ray)
    t9, i9 = ti.closest_hit_loop(o4t, d4t, s.isect_chunk_bounds.contiguous(),
                                 prep.mu, prep.mv, prep.mw)
    assert torch.equal(t9[:pids.numel()], h8.t)


def test_wrappers_check_operands():
    s = build_demo_scene(texture_resolution=8, sphere_detail=6, device="cpu")
    prep = ti.prepare_trace_inputs(s)
    o4t, d4t = ti.pack_rays(demo_camera(16, 16).generate_rays(
        torch.arange(256), rng.prng_seed(torch.arange(256) % 16,
                                         torch.arange(256) // 16, 0),
        RenderConfig())[0])
    cb = s.isect_chunk_bounds.contiguous()
    for fn in (ti.closest_hit_classic, ti.closest_hit_loop):
        with pytest.raises(ValueError, match="shape"):
            fn(o4t, d4t, cb[:, :-1].contiguous(), prep.mu, prep.mv, prep.mw)
        with pytest.raises(ValueError, match="N % 256"):
            fn(o4t[:, :100].contiguous(), d4t[:, :100].contiguous(), cb,
               prep.mu, prep.mv, prep.mw)
        with pytest.raises(ValueError, match="requires grad"):
            fn(o4t.clone().requires_grad_(True), d4t, cb, prep.mu, prep.mv,
               prep.mw)


# (copies of one ray in each of the first `warps` warps of block 0, the
# thread-slots kernel 8's cooperative walk spends per chunk the ray needs,
# counted by hand): k needing rays in nw warps are swept by their own
# threads where 8k > 7 * 32 * nw (nw x 32 lanes x 256 triangles), else a
# warp per ray (ceil(k / 8) rounds x 8 warps x 32 lanes x 8 triangles).
SLOT_CASES = [(1, 1, 1 * 2048),      # one ray: one round of warp sweeps
              (28, 1, 4 * 2048),     # 224 = 7/8 of 256: still warps
              (29, 1, 1 * 32 * 256),  # past 7/8: the warp's own threads
              (28, 8, 28 * 2048),    # 8k = 7 * 32 * 8 exactly: warps
              (29, 8, 8 * 32 * 256)]  # past it: every thread sweeps


@pytest.mark.parametrize("per_warp, warps, per_chunk", SLOT_CASES)
def test_classic_cooperative_slots(per_warp, warps, per_chunk):
    """Kernel 8's plain version counts the thread-slots of its
    block-cooperative walk on a hand-built tile: block 0 holds copies of
    one camera ray that hits (per_warp in each of its first ``warps``
    warps, the rest parked), block 1 only parked rays. Every copy needs
    the same chunks, c of them (its tests / 256), so the walk spends
    c x per_chunk slots, where a thread per ray spends c x 256 x 256; the
    copies all find the ray's own winner."""
    s = build_demo_scene(texture_resolution=8, sphere_detail=6, device="cpu")
    prep = ti.prepare_trace_inputs(s)
    pids = torch.arange(16 * 16)
    ray, _ = demo_camera(16, 16).generate_rays(
        pids, rng.prng_seed(pids % 16, pids // 16, 1), RenderConfig())
    o4, d4 = ti.pack_rays(ray)
    geo = (s.isect_chunk_bounds.contiguous(), prep.mu, prep.mv, prep.mw)
    t0, i0 = ti.closest_hit_classic_plain(o4, d4, *geo)
    r = int(torch.nonzero(t0 < MISS_T)[len(torch.nonzero(t0 < MISS_T)) // 2])
    lanes = torch.tensor([w * 32 + j for w in range(warps)
                          for j in range(per_warp)])
    po4, pd4 = ti.pack_rays(ray, torch.zeros(pids.numel(), dtype=torch.bool))
    o4t, d4t = torch.cat([po4, po4], 1), torch.cat([pd4, pd4], 1)
    o4t[:, lanes], d4t[:, lanes] = o4[:, r:r + 1], d4[:, r:r + 1]
    one = {}
    ti.closest_hit_classic_plain(o4[:, r:r + 1].repeat(1, ti.BN),
                                 d4[:, r:r + 1].repeat(1, ti.BN), *geo,
                                 counts=one)
    chunks = one["tests"] / ti.BN / ti.BT
    assert chunks >= 1 and chunks == int(chunks)
    counts = {}
    t, idx = ti.closest_hit_classic_plain(o4t.contiguous(),
                                          d4t.contiguous(), *geo,
                                          counts=counts)
    assert counts["tests"] == per_warp * warps * chunks * ti.BT
    assert counts["slots"] == chunks * per_chunk
    assert counts["thread_slots"] == chunks * ti.BN * ti.BT
    assert (t[lanes] == t0[r]).all() and (idx[lanes] == i0[r]).all()
    rest = torch.ones(2 * ti.BN, dtype=torch.bool)
    rest[lanes] = False
    assert (t[rest] == MISS_T).all()
