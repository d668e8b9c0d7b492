"""``Traversal.MEGA`` of the port (ops/megakernel.py, kernel 10's plain
version on the CPU) against the JAX package's MEGA in Pallas interpret
mode, and inside the port against its PALLAS standard loop.

Both packages get the same rays and PCG2D seeds, taken from JAX's
``generate_rays`` (XLA's tan is 1 ulp off torch's: ROADMAP §3), on the demo
scene with sphere geometry (``build_demo_scene(texture_resolution=8,
sphere_detail=6, geometry="sphere")``, 8 chunks, as tests/test_mega.py).
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
from gdpathtracing_tpu.ops.megakernel import (
    path_trace_mega as jax_path_trace_mega)
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import megakernel as mk
from gdpathtracing_torch.render.integrator import path_trace
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera)

torch.set_num_threads(1)
W, H = 24, 16
# Paths are chaotic: a 1-ulp difference (XLA's K=4 matmuls in the sweep,
# the cdf's summation order, sin/cos) can send a ray to the other triangle
# of a shared edge or to the neighbouring emitter, and that path then
# diverges. Each comparison with JAX allows 1% of the rays.
MIN_RAYS_OK = 0.99
AOVS = ("radiance", "depth", "steps", "segments", "normal")


@pytest.fixture(scope="module")
def scenes():
    kw = dict(texture_resolution=8, sphere_detail=6, geometry="sphere")
    return jax_demo_scene(**kw), build_demo_scene(device="cpu", **kw)


def _rays(w, h, frame, jitter):
    """JAX's camera rays and seeds of a w x h frame, and the same as torch
    tensors (seeds as int64 words, the port's carrier)."""
    pids = jnp.arange(w * h, dtype=jnp.int32)
    seed = jrng.prng_seed((pids % w).astype(jnp.uint32),
                          (pids // w).astype(jnp.uint32), jnp.uint32(frame))
    ray, seed = jax_demo_camera(w, h).generate_rays(
        pids, seed, JRenderConfig(jitter=jitter))
    tray = Ray(Vec3(*(torch.from_numpy(np.array(x)) for x in ray.o)),
               Vec3(*(torch.from_numpy(np.array(x)) for x in ray.d)))
    tseed = tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                  for x in seed)
    return (ray, seed), (tray, tseed)


@pytest.mark.parametrize("case", [
    dict(bounces=3, nee=False), dict(bounces=3, nee=True),
    dict(bounces=5, nee=False, rr_start=1, rr_min_p=0.05),
    dict(bounces=5, nee=True, rr_start=1, rr_min_p=0.05)],
    ids=["primal", "nee", "rr", "rr-nee"])
def test_mega_matches_jax(scenes, case):
    """Radiance within rtol = atol = 1e-5 and segments equal on >= 99% of
    the rays; depth and normals within 1e-4 on those rays (Russian
    roulette included: its draw and kill are in the kernel in both)."""
    js, ts = scenes
    (jray, jseed), (tray, tseed) = _rays(W, H, 2, JJitter.NONE)
    want = jax_path_trace_mega(
        js, jray, jseed, JRenderConfig(traversal=JTraversal.MEGA, **case),
        interpret=True)
    got = path_trace(ts, tray, tseed,
                     RenderConfig(traversal=Traversal.MEGA, **case))
    rad_j = np.asarray(want.radiance.to_array())
    rad_p = got.radiance.to_array().numpy()
    ok = np.isclose(rad_p, rad_j, rtol=1e-5, atol=1e-5).all(axis=1) & (
        got.segments.numpy() == np.asarray(want.segments))
    assert ok.mean() >= MIN_RAYS_OK, (~ok).sum()
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(want.depth)[ok], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.normal.to_array().numpy()[ok],
                               np.asarray(want.normal.to_array())[ok],
                               rtol=0, atol=1e-4)
    assert float(rad_p.mean()) > 0.0 and np.isfinite(rad_p).all()


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_mega_matches_pallas_standard_loop(scenes, nee):
    """MEGA and the port's PALLAS standard loop run the same walk, shading,
    light sampling and PCG2D stream, so on the same rays radiance agrees
    within rtol 1e-5 / atol 1e-6 and steps are equal (tests/test_mega.py's
    check of JAX's pair); measured: equal bit for bit."""
    _, ts = scenes
    _, (tray, tseed) = _rays(16, 12, 3, JJitter.UNIFORM)
    base = dict(bounces=4, nee=nee, regen=False)
    mega = path_trace(ts, tray, tseed,
                      RenderConfig(traversal=Traversal.MEGA, **base))
    pal = path_trace(ts, tray, tseed,
                     RenderConfig(traversal=Traversal.PALLAS, **base))
    np.testing.assert_allclose(mega.radiance.to_array().numpy(),
                               pal.radiance.to_array().numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(mega.steps, pal.steps)
    assert torch.equal(mega.segments, pal.segments)


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_mega_compaction_bit_transparent(scenes, nee):
    """compact_rays sorts the packed state by octant between bounces, dead
    rays last; every output is per ray, so the AOVs are the same bit for
    bit with it on or off (48x32: six blocks, so tail blocks go all dead
    and pass their state through)."""
    _, ts = scenes
    cam = demo_camera(48, 32)
    base = dict(bounces=4, nee=nee, traversal=Traversal.MEGA)
    on = render_radiance(ts, cam, RenderConfig(compact_rays=True, **base), 1)
    off = render_radiance(ts, cam, RenderConfig(compact_rays=False, **base),
                          1)
    for field in AOVS:
        assert torch.equal(getattr(on, field), getattr(off, field)), field


def test_mega_step_counts_no_cpu_launch(scenes):
    """On the CPU the wrapper runs the plain version: one bounce of a
    render leaves the launch count alone, and a dead ray's state is
    unchanged by a bounce."""
    _, ts = scenes
    prep = mk.prepare_trace_inputs(ts)
    lt = mk._build_light_block(prep.lights, "cpu")
    fs = torch.zeros((24, 256))
    fs[3:6] = 0.5773503
    fs[13], fs[14] = 1000.0, -1.0
    istate = torch.arange(8 * 256, dtype=torch.int32).view(8, 256)
    before = mk.mega_step.launches
    fs2, is2 = mk.mega_step(fs, istate, prep.bounds, prep.sub_bounds,
                            prep.mu, prep.mv, prep.mw, prep.tab, lt, 0,
                            RenderConfig(nee=True))
    assert mk.mega_step.launches == before
    assert torch.equal(fs2, fs) and torch.equal(is2, istate)


def test_mega_gates_and_errors(scenes):
    """mega_supported refuses the mid grid (34 chunks) and path_trace
    raises there; regen=True and differentiable=True raise ValueError for
    MEGA and FUSED, as the reference raises for regen (and has no gradient
    through either kernel)."""
    _, ts = scenes
    cfg = RenderConfig(traversal=Traversal.MEGA)
    assert mk.mega_supported(ts, cfg)
    assert mk.mega_supported(ts, cfg.replace(nee=True))
    mid = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    assert not mk.mega_supported(mid, cfg)
    z = torch.zeros(8)
    ray = Ray(Vec3(z, z, z + 10.0), Vec3(z, z, z - 1.0))
    seed = (z.to(torch.int64), z.to(torch.int64))
    with pytest.raises(ValueError, match="MEGA traversal unsupported"):
        path_trace(mid, ray, seed, cfg)
    assert not mk.mega_supported(ts, cfg.replace(soft_shadows=0.02))
    cam = demo_camera(8, 8)
    for trav in (Traversal.MEGA, Traversal.FUSED):
        with pytest.raises(ValueError, match="regen"):
            render_radiance(ts, cam, RenderConfig(traversal=trav, regen=True))
        with pytest.raises(ValueError, match="no gradient"):
            render_radiance(ts, cam, RenderConfig(traversal=trav,
                                                  differentiable=True))
