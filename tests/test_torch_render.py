"""The ported slice end to end through the standard loop: render_radiance
with Traversal.PALLAS and regen=False, primal and with NEE, against the
PALLAS golden and against the JAX package, plus the configs it refuses.
tests/test_torch_regen.py covers the regeneration loop."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.config import (Jitter as JJitter,
                                      RenderConfig as JRenderConfig,
                                      Traversal as JTraversal)
from gdpathtracing_tpu.render.renderer import (
    render_radiance as jax_render_radiance)
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.post.tonemap import aces_film
from gdpathtracing_torch.render.renderer import render, render_radiance
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
DATA = Path(__file__).parent / "data"
SLICE = RenderConfig(traversal=Traversal.PALLAS, regen=False)
# Paths are chaotic: a 1-ulp difference between XLA's and torch's tan, sin
# and cos (the primary-ray FOV, the BRDF sample) can flip which triangle of
# a shared edge a ray hits, or a grazing hit into a miss, and that path then
# diverges. Such pixels are few: each comparison allows 1% of them.
MIN_PIXELS_OK = 0.99


@pytest.fixture(scope="module")
def scene():
    return build_demo_scene(texture_resolution=8, sphere_detail=6,
                            device="cpu")


def test_golden_pallas_16(scene):
    """tests/data/golden_pallas_16.npz (JAX PALLAS, interpret mode) at
    test_golden.py's tolerance, rtol = atol = 2e-3, on >= 99% of pixels
    (measured: 254 of 256; the other two diverge after a 1-ulp camera-ray
    difference picks the other triangle of a shared edge)."""
    cfg = SLICE.replace(bounces=3, spp=2, jitter=Jitter.NONE)
    img = render_radiance(scene, demo_camera(16, 16), cfg, 0).radiance
    ref = np.load(DATA / "golden_pallas_16.npz")["image"]
    assert img.shape == ref.shape == (16, 16, 3)
    ok = np.isclose(img.numpy(), ref, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()


def test_matches_jax_40x24(scene):
    """The port against JAX render_radiance (regen=False, the PALLAS kernel
    in interpret mode) at 40x24, 4 bounces, frame 3: radiance within 1e-4
    on >= 99% of pixels, segments equal on those pixels, depth within
    rtol 1e-5 there."""
    cam_j = jax_demo_camera(40, 24)
    cfg_j = JRenderConfig(bounces=4, traversal=JTraversal.PALLAS,
                          jitter=JJitter.UNIFORM, regen=False)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref = jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6), cam_j,
            cfg_j, 3)
    finally:
        jip._FORCE_INTERPRET = old
    got = render_radiance(scene, demo_camera(40, 24), SLICE.replace(
        bounces=4), 3)
    ok = (np.abs(got.radiance.numpy() - np.asarray(ref.radiance))
          <= 1e-4).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], rtol=1e-5)
    np.testing.assert_allclose(got.normal.numpy()[ok],
                               np.asarray(ref.normal)[ok], atol=1e-5)
    assert got.segments.numpy().sum() >= 40 * 24


def test_nee_matches_jax_40x24(scene):
    """NEE in the standard loop (kernel 4 each bounce, kernel 2 for the last
    shadow queries) against JAX's standard loop with NEE (its fused kernel,
    interpret mode) at 40x24, 3 bounces, frame 5: the tolerance of
    test_matches_jax_40x24."""
    cfg_j = JRenderConfig(bounces=3, traversal=JTraversal.PALLAS, nee=True,
                          jitter=JJitter.UNIFORM, regen=False)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref = jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6),
            jax_demo_camera(40, 24), cfg_j, 5)
    finally:
        jip._FORCE_INTERPRET = old
    got = render_radiance(scene, demo_camera(40, 24),
                          SLICE.replace(bounces=3, nee=True), 5)
    ok = (np.abs(got.radiance.numpy() - np.asarray(ref.radiance))
          <= 1e-4).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], rtol=1e-5)
    # Shadow rays count as segments: more than one per pixel.
    assert got.segments.numpy().sum() > 40 * 24 * 1.2


def test_compaction_is_result_transparent(scene):
    """Survivor compaction forced on and off gives the same frame, bit for
    bit, with and without NEE: the winner, and every per-ray value, is
    independent of which rays share a block, and the pending shadow
    queries move with their rays."""
    cam = demo_camera(40, 24)
    for nee in (False, True):
        cfg = SLICE.replace(bounces=4, nee=nee)
        on = render_radiance(scene, cam, cfg.replace(compact_rays=True), 3)
        off = render_radiance(scene, cam, cfg.replace(compact_rays=False), 3)
        for a, b in zip(on, off):
            assert torch.equal(a, b)


def test_ray_sort_is_result_transparent(scene):
    """The per-bounce Morton x octant sort forced on gives the frame of the
    unsorted loop, bit for bit, with and without NEE: with the fused NEE
    the pending shadow queries move with their rays."""
    cam = demo_camera(40, 24)
    for nee in (False, True):
        cfg = SLICE.replace(bounces=4, nee=nee)
        on = render_radiance(scene, cam, cfg.replace(sort_rays=True), 3)
        off = render_radiance(scene, cam, cfg.replace(sort_rays=False), 3)
        for a, b in zip(on, off):
            assert torch.equal(a, b)


def test_tiles_and_spp(scene):
    """Several tiles (tile_rays < pixels, last tile wrapping) and spp 2 give
    the one-tile frame."""
    cam = demo_camera(24, 16)
    cfg = SLICE.replace(bounces=2, spp=2)
    one = render_radiance(scene, cam, cfg, 1)
    tiled = render_radiance(scene, cam, cfg.replace(tile_rays=160), 1)
    for a, b in zip(one, tiled):
        assert torch.equal(a, b)
    assert one.radiance.dtype == torch.float32
    assert one.segments.dtype == one.steps.dtype == torch.int32


def test_render_tonemaps(scene):
    cam = demo_camera(16, 16)
    img = render(scene, cam, SLICE.replace(bounces=2), 0)
    lin = render_radiance(scene, cam, SLICE.replace(bounces=2), 0).radiance
    assert torch.equal(img, aces_film(lin))
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def _jax_frame(change: dict, w: int, h: int, frame: int = 0):
    """JAX's render_radiance of SLICE.replace(**change) on the demo (the
    PALLAS kernels in interpret mode)."""
    kw = dict(traversal=JTraversal.PALLAS, regen=False)
    kw.update({k: getattr(JTraversal, v.name) if isinstance(v, Traversal)
               else v for k, v in change.items()})
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        return jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6),
            jax_demo_camera(w, h), JRenderConfig(**kw), frame)
    finally:
        jip._FORCE_INTERPRET = old


def _matches_jax(got, ref):
    """Radiance within test_golden.py's 2e-3 on >= 99% of pixels, segments
    equal there."""
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=2e-3, atol=2e-3).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])


# Item 5 of ROADMAP queue 1: regen's fused NEE on a flat scene and its
# first-chunk sort key on sorted lanes still raise.
ITEM_5 = ("regen_fuse_nee", "regen_sort_key")


@pytest.mark.parametrize("change", [
    dict(traversal=Traversal.BVH, rr_start=2),
    dict(regen=True, nee=True, regen_fuse_nee=True),
    # the march is ignored on the flat demo (march_supported is false), so
    # the first-chunk key of the sorted lanes is read
    dict(regen=True, regen_march=True, regen_sort_key="chunk"),
    dict(regen=True, regen_sort_key="chunk"),
    dict(traversal=Traversal.BRUTE), dict(rr_start=2),
    dict(traversal=Traversal.UNIT)])
def test_outside_the_slice_raises(scene, change):
    """Regen's item-5 options raise, naming the ROADMAP; what item 3
    brought in (BRUTE, UNIT, Russian roulette on PALLAS and BVH) renders:
    finite, on the scene's device, and equal to JAX's frame at 16x16
    (3 bounces; 5 with Russian roulette, which starts at bounce 2)."""
    cfg = SLICE.replace(**change)
    if any(k in change for k in ITEM_5):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render_radiance(scene, demo_camera(8, 8), cfg)
        return
    bounces = 5 if "rr_start" in change else 3
    got = render_radiance(scene, demo_camera(16, 16),
                          cfg.replace(bounces=bounces), 1)
    assert got.radiance.device == scene.device
    assert bool(torch.isfinite(got.radiance).all())
    _matches_jax(got, _jax_frame(dict(change, bounces=bounces), 16, 16, 1))


def test_default_config_raises(scene):
    """The default config (Traversal.BVH) with Russian roulette renders
    (it raised until item 3 came in): ``render`` tonemaps it, and the
    linear frame equals JAX's at 16x16, 5 bounces."""
    cfg = RenderConfig(rr_start=2, bounces=5)
    img = render(scene, demo_camera(16, 16), cfg, 2)
    lin = render_radiance(scene, demo_camera(16, 16), cfg, 2)
    assert torch.equal(img, aces_film(lin.radiance))
    assert img.device == scene.device
    assert bool(torch.isfinite(img).all())
    _matches_jax(lin, jax_render_radiance(
        jax_demo_scene(texture_resolution=8, sphere_detail=6),
        jax_demo_camera(16, 16), JRenderConfig(rr_start=2, bounces=5), 2))


@pytest.mark.parametrize("lite", [True, False], ids=["lite", "rows"])
def test_superchunk_scene_renders(lite, monkeypatch):
    """A 22-chunk scene (3 superchunks) renders on the CPU, through kernel
    3's plain version and, with ``_SC_LITE`` off, through kernel 6's; the
    two give the same frame up to the lite path's other shading sums."""
    grid = build_sphere_grid(n=5, sphere_detail=8, device="cpu")
    assert grid.isect_mu.shape[1] // 256 > 16
    cam = grid_camera(16, 12, n=5)
    cfg = SLICE.replace(bounces=3, nee=True)
    ref = render_radiance(grid, cam, cfg, 1)  # the default: lite
    monkeypatch.setattr(ti, "_SC_LITE", lite)
    calls = {}
    for name in ("closest_hit_sc_lite_plain", "closest_hit_rows_sc_plain"):
        monkeypatch.setattr(ti, name, _counting(getattr(ti, name), calls,
                                                name))
    got = render_radiance(grid, cam, cfg, 1)
    assert set(calls) == {"closest_hit_sc_lite_plain" if lite
                          else "closest_hit_rows_sc_plain"}
    assert got.radiance.shape == (12, 16, 3)
    assert bool(torch.isfinite(got.radiance).all())
    assert float(got.radiance.mean()) > 0.0
    ok = (torch.abs(got.radiance - ref.radiance) <= 1e-4).all(dim=-1)
    assert ok.float().mean() >= MIN_PIXELS_OK
    assert torch.equal(got.segments[ok], ref.segments[ok])


def _counting(fn, calls, name):
    def wrapped(*args):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args)
    return wrapped
