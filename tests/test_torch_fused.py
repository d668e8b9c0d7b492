"""``Traversal.FUSED`` of the port (ops/fused.py, kernel 11's plain version
on the CPU) against the JAX package's FUSED in Pallas interpret mode, and
inside the port against its PALLAS standard loop, on flat scenes and on a
scene of more than 16 chunks (FUSED walks every chunk flat).

Both packages get the same rays and PCG2D seeds, taken from JAX's
``generate_rays``, as tests/test_fused.py builds them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdpathtracing_tpu.config import (Jitter as JJitter,
                                      RenderConfig as JRenderConfig,
                                      Traversal as JTraversal)
from gdpathtracing_tpu.core import rng as jrng
from gdpathtracing_tpu.ops.fused_pallas import (
    path_trace_fused as jax_path_trace_fused)
from gdpathtracing_tpu.scene.demo import (
    build_cornell_simple as jax_cornell_simple,
    build_demo_scene as jax_demo_scene, demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import fused as fu
from gdpathtracing_torch.render.integrator import path_trace
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene.demo import (build_cornell_simple,
                                            build_demo_scene,
                                            build_sphere_grid, grid_camera)

torch.set_num_threads(1)
RES = 24
# FUSED against the port's PALLAS standard loop on the same rays: the two
# differ only where FUSED keeps the reference's own rules (u and v not
# clipped to [0, 1], throughput multiplied as (tp * f) * scale, not
# tp * (f * scale)), each a few ulps on a few rays, and a path that such an
# ulp sends to the other side of an edge diverges. So radiance agrees
# within 1e-5 on >= 99% of the rays (measured: 100% within 6e-8 on the
# demo scene), tighter than JAX's FUSED/UNIT pair (1e-3, tests/
# test_fused.py), whose walk also took the raw boxes with a strict gate.
PALLAS_TOL, PALLAS_MIN_OK = 1e-5, 0.99


@pytest.fixture(scope="module")
def scenes():
    demo = dict(texture_resolution=8, sphere_detail=6, geometry="sphere")
    return {"cornell": (jax_cornell_simple(),
                        build_cornell_simple(device="cpu")),
            "demo": (jax_demo_scene(**demo),
                     build_demo_scene(device="cpu", **demo))}


def _rays(res, frame=0):
    """JAX's camera rays and seeds of a res x res frame (no jitter), and the
    same as torch tensors (seeds as int64 words, the port's carrier)."""
    pids = jnp.arange(res * res, dtype=jnp.int32)
    seed = jrng.prng_seed((pids % res).astype(jnp.uint32),
                          (pids // res).astype(jnp.uint32), jnp.uint32(frame))
    ray, seed = jax_demo_camera(res, res).generate_rays(
        pids, seed, JRenderConfig(jitter=JJitter.NONE))
    tray = Ray(Vec3(*(torch.from_numpy(np.array(x)) for x in ray.o)),
               Vec3(*(torch.from_numpy(np.array(x)) for x in ray.d)))
    tseed = tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                  for x in seed)
    return (ray, seed), (tray, tseed)


@pytest.mark.parametrize("name,bounces", [("cornell", 1), ("cornell", 3),
                                          ("demo", 2)])
def test_fused_matches_jax(scenes, name, bounces):
    """tests/test_fused.py's tolerances: per ray within 1e-3 on more than
    99% of the rays, the mean within 5e-3, depth within 1e-2 and segments
    equal on more than 99%; unit normals on the hits."""
    js, ts = scenes[name]
    (jray, jseed), (tray, tseed) = _rays(RES)
    want = jax_path_trace_fused(
        js, jray, jseed,
        JRenderConfig(bounces=bounces, traversal=JTraversal.FUSED),
        interpret=True)
    got = path_trace(ts, tray, tseed, RenderConfig(
        bounces=bounces, traversal=Traversal.FUSED))
    a = np.asarray(want.radiance.to_array())
    b = got.radiance.to_array().numpy()
    assert np.isfinite(b).all()
    assert (np.abs(a - b).max(axis=1) < 1e-3).mean() > 0.99
    assert abs(a.mean() - b.mean()) < 5e-3
    assert (np.abs(np.asarray(want.depth) - got.depth.numpy())
            < 1e-2).mean() > 0.99
    assert (np.asarray(want.segments) == got.segments.numpy()).mean() > 0.99
    assert torch.equal(got.steps, got.segments * ts.isect_mu.shape[1])
    hitm = got.depth.numpy() < 999
    lens = np.linalg.norm(got.normal.to_array().numpy(), axis=1)
    assert hitm.any() and np.allclose(lens[hitm], 1.0, atol=1e-3)


@pytest.mark.parametrize("name", ["cornell", "demo"])
def test_fused_matches_pallas_standard_loop(scenes, name):
    """FUSED against the port's PALLAS standard loop on the same rays,
    radiance within PALLAS_TOL on PALLAS_MIN_OK of the rays."""
    _, ts = scenes[name]
    _, (tray, tseed) = _rays(RES, frame=1)
    fused = path_trace(ts, tray, tseed, RenderConfig(
        bounces=3, traversal=Traversal.FUSED))
    pal = path_trace(ts, tray, tseed, RenderConfig(
        bounces=3, traversal=Traversal.PALLAS, regen=False))
    diff = (fused.radiance.to_array() - pal.radiance.to_array()).abs()
    assert (diff.amax(dim=1) <= PALLAS_TOL).float().mean() >= PALLAS_MIN_OK
    assert float(fused.radiance.to_array().mean()) > 0.0


def test_fused_renders_superchunk_scene():
    """A 22-chunk grid (over the 16-chunk flat limit of the other flat
    kernels): FUSED walks it flat and agrees with the port's PALLAS
    standard loop, which takes the two-level kernel 3 there."""
    grid = build_sphere_grid(n=5, sphere_detail=8, device="cpu")
    assert grid.isect_mu.shape[1] // 256 > 16
    cam = grid_camera(16, 12, n=5)
    cfg = RenderConfig(bounces=3, traversal=Traversal.FUSED)
    assert fu.fused_supported(grid, cfg)
    fused = render_radiance(grid, cam, cfg, 1)
    pal = render_radiance(grid, cam, cfg.replace(
        traversal=Traversal.PALLAS, regen=False), 1)
    assert bool(torch.isfinite(fused.radiance).all())
    assert float(fused.radiance.mean()) > 0.0
    ok = ((fused.radiance - pal.radiance).abs() <= PALLAS_TOL).all(dim=-1)
    assert ok.float().mean() >= PALLAS_MIN_OK
    assert torch.equal(fused.segments[ok], pal.segments[ok])


def test_fused_gates(scenes):
    """fused_supported: the reference's gate (no NEE, no Russian roulette,
    at most 16384 triangles); path_trace raises its ValueError outside."""
    _, ts = scenes["cornell"]
    cfg = RenderConfig(traversal=Traversal.FUSED)
    assert fu.fused_supported(ts, cfg)
    assert not fu.fused_supported(ts, cfg.replace(nee=True))
    assert not fu.fused_supported(ts, cfg.replace(rr_start=1))
    z = torch.zeros(8)
    ray = Ray(Vec3(z, z, z + 10.0), Vec3(z, z, z - 1.0))
    seed = (z.to(torch.int64), z.to(torch.int64))
    with pytest.raises(ValueError, match="FUSED traversal unsupported"):
        path_trace(ts, ray, seed, cfg.replace(nee=True))


def test_fused_paths_plain_on_cpu(scenes):
    """On the CPU the wrapper runs the plain version (no launch counted);
    a ray parked outside the scene misses, takes the sky once and dies."""
    _, ts = scenes["demo"]
    prep = fu.prepare_trace_inputs(ts)
    o4t = torch.zeros((4, 256))
    o4t[0:3], o4t[3] = 1e9, 1.0
    d4t = torch.zeros((4, 256))
    d4t[0:3] = 0.5773503
    seeds = torch.zeros((2, 256), dtype=torch.int32)
    before = fu.fused_paths.launches
    out, segs = fu.fused_paths(o4t, d4t, seeds, prep.bounds, prep.mu,
                               prep.mv, prep.mw, fu._build_table(ts),
                               fu._build_mats(ts),
                               RenderConfig(bounces=3))
    assert fu.fused_paths.launches == before
    assert torch.equal(segs, torch.ones(256, dtype=torch.int32))
    assert torch.equal(out[3], torch.full((256,), 1e9))
    assert float(out[0:3].min()) > 0.0
