"""Regen's two options outside the default (render/regen.py): fused NEE
(``regen_fuse_nee=True``, the shadow queries riding the next iteration's
kernel 4 launch, with pending queries and deferred rows) and the
first-chunk lane key (``regen_sort_key="chunk"``), against the port's own
standard loop and default frames and against the JAX package's
(tests/test_regen.py:78-108's cases, the PALLAS kernels in interpret
mode)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.config import RenderConfig as JRenderConfig
from gdpathtracing_tpu.config import Traversal as JTraversal
from gdpathtracing_tpu.render.renderer import (
    render_radiance as jax_render_radiance)
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render import regen
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
W, H = 40, 24
AOVS = ("radiance", "depth", "steps", "segments", "normal")
# tests/test_regen.py's fused cases: PALLAS + NEE, 3 bounces, 1024 lanes.
FUSED = RenderConfig(bounces=3, traversal=Traversal.PALLAS, nee=True,
                     regen_fuse_nee=True, tile_rays=1024,
                     regen_wavefront=1024)


@pytest.fixture(scope="module")
def scene():
    """tests/test_regen.py's scene: the demo room with a sphere (1 chunk)."""
    return build_demo_scene(texture_resolution=8, sphere_detail=6,
                            geometry="sphere", device="cpu")


@pytest.fixture(scope="module")
def demo():
    """The demo scene (8 chunks), for the first-chunk key."""
    return build_demo_scene(texture_resolution=8, sphere_detail=6,
                            device="cpu")


def _assert_equal(got, ref):
    for k in AOVS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def _compare(got, ref):
    """tests/test_regen.py's ``_compare``."""
    np.testing.assert_allclose(got.radiance.numpy(), ref.radiance.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.depth.numpy(), ref.depth.numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.segments.numpy(), ref.segments.numpy())
    np.testing.assert_allclose(got.normal.numpy(), ref.normal.numpy(),
                               atol=1e-6)


def _counting(monkeypatch, name):
    """Count the calls regen makes to its ``name``."""
    calls = []
    real = getattr(regen, name)
    monkeypatch.setattr(regen, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


# Each a change of FUSED: the pending state across the lane permutation
# (sorted, the 3-way partition, none), late rows in the log and in the
# scatter retirement, many regeneration rounds, two samples a pixel.
FUSED_VARIANTS = {
    "default": {},
    "no_compaction": dict(compact_rays=False),
    "partition": dict(sort_rays=False),
    "scatter": dict(regen_retire="scatter"),
    "wavefront": dict(regen_wavefront=256),
    "spp": dict(spp=2, regen_wavefront=512),
    "chunk_key": dict(regen_sort_key="chunk"),
}


@pytest.mark.parametrize("variant", sorted(FUSED_VARIANTS))
def test_fused_matches_standard_loop(scene, variant, monkeypatch):
    """The fused regen frame against the standard loop + NEE (which fuses
    too, kernel 4 a bounce) as tests/test_regen.py holds them, and bit for
    bit against regen's unfused NEE; one kernel 4 launch an iteration and
    no occlusion launch."""
    cfg = FUSED.replace(**FUSED_VARIANTS[variant])
    cam = demo_camera(W, H)
    fused = _counting(monkeypatch, "trace_occlude_pallas")
    occl = _counting(monkeypatch, "occluded_pallas")
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg.replace(regen=True), 3)
    assert len(fused) == regen.render_radiance_regen.iterations > 3
    assert not occl
    _compare(got, render_radiance(scene, cam, cfg.replace(regen=False), 3))
    _assert_equal(got, render_radiance(
        scene, cam, cfg.replace(regen=True, regen_fuse_nee=False), 3))
    assert len(occl) > 0


@pytest.mark.parametrize("compact", [None, False],
                         ids=["compacted", "no_compaction"])
def test_fused_matches_jax(scene, compact):
    """tests/test_regen.py:78-89 and 98-108 on both packages (JAX's PALLAS
    in interpret mode): radiance within 2e-3 on >= 99% of pixels, segments
    equal on >= 99% (the pinned tan divergence, ROADMAP §3)."""
    cfg = FUSED.replace(regen=True, compact_rays=compact)
    got = render_radiance(scene, demo_camera(W, H), cfg, 3)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref = jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6,
                           geometry="sphere"), jax_demo_camera(W, H),
            JRenderConfig(bounces=3, traversal=JTraversal.PALLAS, nee=True,
                          regen_fuse_nee=True, compact_rays=compact,
                          regen=True, tile_rays=1024, regen_wavefront=1024),
            3)
    finally:
        jip._FORCE_INTERPRET = old
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=2e-3, atol=2e-3).all(axis=-1)
    assert ok.mean() >= 0.99, (~ok).sum()
    same = got.segments.numpy() == np.asarray(ref.segments)
    assert same.mean() >= 0.99, (~same).sum()


def test_fused_on_superchunk_scene_is_unfused():
    """On a superchunk scene regen renders unfused NEE, as the reference."""
    grid = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    cam = grid_camera(16, 12, n=4)
    cfg = FUSED.replace(regen=True)
    _assert_equal(render_radiance(grid, cam, cfg, 1),
                  render_radiance(grid, cam, cfg.replace(
                      regen_fuse_nee=False), 1))


# The smallest build_sphere_grid of more than 64 chunks: n=5 at the default
# sphere_detail, 94 chunks, so the key tests 12 superchunk boxes.
@pytest.mark.parametrize("where", ["demo", "grid", "grid_nee"])
def test_chunk_key_frame_equals_default(demo, where, monkeypatch):
    if where == "demo":
        s, cam = demo, demo_camera(W, H)
    else:
        s, cam = build_sphere_grid(n=5, device="cpu"), grid_camera(24, 16,
                                                                   n=5)
        assert s.isect_chunk_bounds.shape[1] == 94
    cfg = RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                       nee=where == "grid_nee", regen_wavefront=256)
    keys = _counting(monkeypatch, "first_chunk_key")
    got = render_radiance(s, cam, cfg.replace(regen_sort_key="chunk"), 2)
    assert keys
    _assert_equal(got, render_radiance(s, cam, cfg, 2))


def test_chunk_key_matches_jax(demo):
    """The port's chunk-key frame against JAX's (interpret mode): the
    image tolerance of tests/test_torch_render.py."""
    cfg = RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                       regen_sort_key="chunk", regen_wavefront=256)
    got = render_radiance(demo, demo_camera(W, H), cfg, 2)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref = jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6),
            jax_demo_camera(W, H),
            JRenderConfig(bounces=3, traversal=JTraversal.PALLAS,
                          regen_sort_key="chunk", regen_wavefront=256), 2)
    finally:
        jip._FORCE_INTERPRET = old
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=2e-3, atol=2e-3).all(axis=-1)
    assert ok.mean() >= 0.99, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])


def _jax_key_bounds(cb):
    """JAX regen.py:294-314, transcribed (a closure there)."""
    nc_key = int(cb.shape[1])
    if nc_key > 64:
        SCC = 8
        pad = (-nc_key) % SCC
        cbp = jnp.pad(cb, ((0, 0), (0, pad)), constant_values=1e30)
        nsc_key = cbp.shape[1] // SCC
        lo = cbp[0:3].reshape(3, nsc_key, SCC).min(axis=2)
        hi = jnp.where(
            cbp[3:6].reshape(3, nsc_key, SCC) > 1e29, -1e30,
            cbp[3:6].reshape(3, nsc_key, SCC)).max(axis=2)
        cb = jnp.concatenate(
            [lo, hi, jnp.zeros((2, nsc_key), jnp.float32)], axis=0)
    return cb


def _jax_first_chunk_key(o, d, alive, fresh, key_cb):
    """JAX regen.py:316-349, transcribed (a closure there); o and d are
    (3, N) arrays."""
    cb = key_cb
    nc_key = int(cb.shape[1])
    ox, oy, oz = o
    dx, dy, dz = d
    rdx = 1.0 / jnp.where(jnp.abs(dx) < 1e-30, 1e-30, dx)
    rdy = 1.0 / jnp.where(jnp.abs(dy) < 1e-30, 1e-30, dy)
    rdz = 1.0 / jnp.where(jnp.abs(dz) < 1e-30, 1e-30, dz)
    best_t = jnp.full_like(ox, jnp.inf)
    best_c = jnp.zeros_like(ox, dtype=jnp.int32) + nc_key
    for ci in range(nc_key):
        tx1 = (cb[0, ci] - ox) * rdx
        tx2 = (cb[3, ci] - ox) * rdx
        ty1 = (cb[1, ci] - oy) * rdy
        ty2 = (cb[4, ci] - oy) * rdy
        tz1 = (cb[2, ci] - oz) * rdz
        tz2 = (cb[5, ci] - oz) * rdz
        tmin = jnp.maximum(jnp.maximum(jnp.minimum(tx1, tx2),
                                       jnp.minimum(ty1, ty2)),
                           jnp.minimum(tz1, tz2))
        tmax = jnp.minimum(jnp.minimum(jnp.maximum(tx1, tx2),
                                       jnp.maximum(ty1, ty2)),
                           jnp.maximum(tz1, tz2))
        entry = jnp.maximum(tmin, 0.0)
        ok = (tmax >= tmin) & (tmax > 0.0) & (entry < best_t)
        best_t = jnp.where(ok, entry, best_t)
        best_c = jnp.where(ok, ci, best_c)
    octant = ((dx > 0.0).astype(jnp.int32) * 4
              + (dy > 0.0).astype(jnp.int32) * 2
              + (dz > 0.0).astype(jnp.int32))
    return jnp.where(alive, best_c * 8 + octant,
                     jnp.where(fresh, 1 << 14, 1 << 15))


@pytest.mark.parametrize("where", ["demo", "grid"])
def test_first_chunk_key_matches_transcription(demo, where):
    """first_chunk_key and chunk_key_bounds on seeded rays against the
    transcription of JAX's closures: the boxes bit for bit, the keys
    equal. The rays start inside and outside the scene, some axis-aligned
    (a zero direction component), some behind every box."""
    s = demo if where == "demo" else build_sphere_grid(n=5, device="cpu")
    cb = s.isect_chunk_bounds
    bounds = regen.chunk_key_bounds(cb)
    want_b = np.asarray(_jax_key_bounds(jnp.asarray(cb.numpy())))
    assert bounds.shape == want_b.shape == ((8, 8) if where == "demo"
                                            else (8, 12))
    np.testing.assert_array_equal(bounds.numpy().view(np.uint32),
                                  want_b.view(np.uint32))
    rs = np.random.RandomState(0)
    n = 2048
    lo, hi = cb[0:3].amin(dim=1).numpy(), cb[3:6].amax(dim=1).numpy()
    o = rs.uniform(lo - 2.0, hi + 2.0, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[::7, rs.randint(3)] = 0.0
    d[::11] = 0.0
    d[::11, 1] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rs.uniform(size=n) < 0.8
    fresh = rs.uniform(size=n) < 0.5
    got = regen.first_chunk_key(
        Vec3(*torch.from_numpy(o.T.copy())),
        Vec3(*torch.from_numpy(d.T.copy())), torch.from_numpy(alive),
        torch.from_numpy(fresh), bounds)
    want = _jax_first_chunk_key(jnp.asarray(o.T), jnp.asarray(d.T),
                                jnp.asarray(alive), jnp.asarray(fresh),
                                jnp.asarray(want_b))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    best = got.numpy()[alive] // 8
    assert (best < bounds.shape[1]).any() and (best == bounds.shape[1]).any()
