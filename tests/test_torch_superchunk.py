"""The superchunk path of the port (scenes of more than 16 chunks) against
the JAX package, on the mid-size sphere grid ``build_sphere_grid(n=4,
sphere_detail=12)``: 34 chunks, padded to 40, in 5 superchunks of 8.

- ``prepare_trace_inputs``: padded triangle rows, chunk and superchunk
  boxes, ``tri_inst`` and ``scc``, bit for bit;
- kernels 3 (``closest_hit_sc_lite``) and 6 (``closest_hit_rows_sc``)
  through their plain versions, against JAX's kernels in Pallas interpret
  mode, on 512 rays from a numpy seed (camera rays, random rays, parked
  rays);
- ``lite_epilogue``, ``get_shading_data_fast`` and ``light_pdf_of_hit`` on
  those hits;
- ``render_radiance`` through regen and the standard loop, with and
  without NEE, against JAX's;
- inside the port: the per-bounce ray sort and regen change no bit.
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
from gdpathtracing_tpu.render import lights as jlights
from gdpathtracing_tpu.render import shading as jshading
from gdpathtracing_tpu.render.renderer import (
    render_radiance as jax_render_radiance)
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import (
    build_sphere_grid as jax_sphere_grid, grid_camera as jax_grid_camera)

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render import lights, shading
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera

torch.set_num_threads(1)
N_GRID, DETAIL = 4, 12
W, H = 16, 12
AOVS = ("radiance", "depth", "steps", "segments", "normal")
# t: JAX's kernels take the 4-term dots as a K=4 matmul, which sums in
# another order than the port's left-to-right products. t = -w_o / w_d,
# and w_o cancels terms of |origin| x |row| ~ 10 on this grid, so t keeps
# a few ulps of those terms as an absolute error (measured: 42 of the 512
# rays differ, by at most 4.8e-6). The winners (eidx) are equal.
T_RTOL, T_ATOL = 1e-6, 5e-6
# Rows 0-39 of kernel 6 for the same winner: JAX merges a new winner as
# old + (new - old) * 1 and builds the light rows 30-33 in another
# summation order (~1 ulp; tests/test_torch_intersect.py). u = u_o +
# t * u_d and v carry t's absolute error times |u_d| (measured: at most
# 1.5e-5 on these rays).
ROWS_RTOL, ROWS_ATOL, UVW_ATOL = 1e-6, 2e-7, 3e-5
# The epilogue, the shading fetch and the light pdf: XLA may contract or
# reorder the 4-term dots and the normalisation by an ulp or two.
EPI_RTOL, EPI_ATOL = 1e-5, 1e-6
# Whole frames against JAX: 2e-3 on >= 99% of pixels. Paths are chaotic,
# and the lite path's shading normals come from other sums than the rows
# path's, so the tolerance is wider than the demo comparisons' 1e-4.
FRAME_ATOL, MIN_PIXELS_OK = 2e-3, 0.99


@pytest.fixture(scope="module")
def scenes():
    js = jax_sphere_grid(n=N_GRID, sphere_detail=DETAIL)
    ts = build_sphere_grid(n=N_GRID, sphere_detail=DETAIL, device="cpu")
    return js, ts, jip.prepare_trace_inputs(js), ti.prepare_trace_inputs(ts)


@pytest.fixture(scope="module")
def rays(scenes):
    """512 rays as (4, N) numpy o4/d4: the primary rays of a 16x12 grid
    camera, 256 random rays from above the grid and 64 parked ones, in a
    seeded random order."""
    cam = grid_camera(W, H, n=N_GRID)
    pids = torch.arange(W * H)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % W, pids // W, 1),
                               RenderConfig())
    g = np.random.default_rng(3)
    o = np.stack([g.uniform(-6, 6, 256), g.uniform(-0.5, 7.5, 256),
                  g.uniform(-6, 6, 256)]).astype(np.float32)
    d = g.normal(size=(3, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    park_o = np.full((3, 64), 1e9, np.float32)
    park_d = np.full((3, 64), 0.5773503, np.float32)
    o = np.concatenate([ray.o.to_array(0).numpy(), o, park_o], axis=1)
    d = np.concatenate([ray.d.to_array(0).numpy(), d, park_d], axis=1)
    perm = g.permutation(o.shape[1])
    n = o.shape[1]
    o4 = np.concatenate([o[:, perm], np.ones((1, n), np.float32)])
    d4 = np.concatenate([d[:, perm], np.zeros((1, n), np.float32)])
    return np.ascontiguousarray(o4), np.ascontiguousarray(d4)


def _jax_lite(jp, o4, d4):
    return np.asarray(jip._closest_hit_sc_lite(
        jnp.asarray(o4), jnp.asarray(d4), jp.sc_flat, jp.chunk_flat, jp.m3,
        scc=jp.scc, interpret=True))


def test_prepare_trace_inputs_matches_jax(scenes):
    js, ts, jp, tp = scenes
    assert jp.superchunks and tp.superchunks
    assert tp.scc == jp.scc == 8
    e_pad = tp.mu_pad.shape[1]
    nc_pad = e_pad // ti.BT
    assert (e_pad, nc_pad) == (40 * 256, 40)
    # JAX's m3 interleaves the rows per chunk: [c0 mu | c0 mv | c0 mw | ...].
    m3 = np.asarray(jp.m3).reshape(4, nc_pad, 3, ti.BT)
    for k, got in enumerate((tp.mu_pad, tp.mv_pad, tp.mw_pad)):
        np.testing.assert_array_equal(got.numpy(),
                                      m3[:, :, k].reshape(4, e_pad))
    np.testing.assert_array_equal(
        tp.chunk_bounds.numpy(),
        np.asarray(jp.chunk_flat).reshape(nc_pad, 8).T)
    np.testing.assert_array_equal(
        tp.sc_bounds.numpy(), np.asarray(jp.sc_flat).reshape(-1, 8).T)
    assert tp.sc_bounds.shape == (8, 5)
    np.testing.assert_array_equal(tp.tri_inst.numpy(),
                                  np.asarray(jp.tri_inst))
    # The pad chunks stay at their far point boxes.
    assert (tp.chunk_bounds[0:6, 34:] > 1e29).all()
    # Kernel 2 keeps the unpadded flat operands.
    assert tp.mu.shape == (4, 34 * 256) and tp.bounds.shape == (8, 34)
    assert tp.sub_bounds.shape == (8, ti.SUB * 34)
    assert tp.tab.shape == (ti.TAB_R, e_pad)
    assert tp.m3_bytes == np.asarray(jp.m3).size * 4


def test_closest_hit_sc_lite_plain_matches_jax(scenes, rays):
    js, ts, jp, tp = scenes
    o4, d4 = rays
    want = _jax_lite(jp, o4, d4)
    before = ti.closest_hit_sc_lite.launches
    got = ti.closest_hit_sc_lite(
        torch.from_numpy(o4), torch.from_numpy(d4), tp.sc_bounds,
        tp.chunk_bounds, tp.group_bounds, tp.mu_pad, tp.mv_pad, tp.mw_pad,
        tp.scc).numpy()
    assert ti.closest_hit_sc_lite.launches == before  # the plain version
    assert got.shape == want.shape == (ti.LITE_R, 512)
    hit = want[0] < MISS_T
    assert 150 < hit.sum() < 512 - 64
    np.testing.assert_allclose(got[0], want[0], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][~hit] == MISS_T).all()
    # Steps (row 2) and block entries (row 3) depend on the visit order;
    # here: whole chunks, nothing for parked rays, rows 4-7 zero.
    parked = o4[0] > 1e8
    assert (got[2] % ti.BT == 0).all() and (got[2][parked] == 0).all()
    assert (got[2][hit] >= ti.BT).all()
    assert ((got[3] >= 1) & (got[3] <= 5)).all()
    assert (got[4:] == 0).all()


def test_closest_hit_rows_sc_plain_matches_jax(scenes, rays):
    js, ts, jp, tp = scenes
    o4, d4 = rays
    want = np.asarray(jip._closest_hit_rows_sc(
        jnp.asarray(o4), jnp.asarray(d4), jp.sc_flat, jp.chunk_flat, jp.m3,
        jp.tab, scc=jp.scc, interpret=True))
    got = ti.closest_hit_rows_sc(
        torch.from_numpy(o4), torch.from_numpy(d4), tp.sc_bounds,
        tp.chunk_bounds, tp.mu_pad, tp.mv_pad, tp.mw_pad, tp.tab,
        tp.scc).numpy()
    assert got.shape == want.shape == (ti.OUT_R, 512)
    np.testing.assert_allclose(got[40], want[40], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(got[44], want[44])
    np.testing.assert_allclose(got[:ti.TAB_R], want[:ti.TAB_R],
                               rtol=ROWS_RTOL, atol=ROWS_ATOL)
    np.testing.assert_allclose(got[41:44], want[41:44], atol=UVW_ATOL)
    # The lite kernel finds the same winners, with the same steps.
    lite = ti.closest_hit_sc_lite_plain(
        torch.from_numpy(o4), torch.from_numpy(d4), tp.sc_bounds,
        tp.chunk_bounds, tp.group_bounds, tp.mu_pad, tp.mv_pad, tp.mw_pad,
        tp.scc).numpy()
    np.testing.assert_array_equal(lite[[0, 1, 2, 3]], got[[40, 44, 45, 46]])
    assert (got[47] >= got[46]).all()  # chunks swept, superchunks entered


def _hits(scenes, rays):
    """(JAX ray, port ray, JAX hit, port hit) of the lite epilogue on the
    JAX lite kernel's winners; a fifth of the rays inactive."""
    js, ts, jp, tp = scenes
    o4, d4 = rays
    lite = _jax_lite(jp, o4, d4)
    active = np.random.default_rng(5).uniform(size=o4.shape[1]) > 0.2
    jray = JRay(JVec3(*map(jnp.asarray, o4[:3])),
                JVec3(*map(jnp.asarray, d4[:3])))
    tray = Ray(Vec3(*map(torch.from_numpy, o4[:3])),
               Vec3(*map(torch.from_numpy, d4[:3])))
    jh = jip.lite_epilogue(js, jp, jray, jnp.asarray(active),
                           jnp.asarray(lite[0]),
                           jnp.asarray(lite[1].astype(np.int32)))
    th = ti.lite_epilogue(ts, tp, tray, torch.from_numpy(active),
                          torch.from_numpy(lite[0]),
                          torch.from_numpy(lite[1].astype(np.int32)))
    return jray, tray, jh, th


def test_lite_epilogue_matches_jax(scenes, rays):
    _, _, jh, th = _hits(scenes, rays)
    assert th.rows is None
    for f in ("t", "tri", "inst", "front", "eidx"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), f)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)),
                                   rtol=EPI_RTOL, atol=EPI_ATOL)
    assert th.tri.dtype == th.inst.dtype == th.eidx.dtype == torch.int32


def test_shading_and_light_pdf_fast_match_jax(scenes, rays):
    js, ts, jp, tp = scenes
    jray, tray, jh, th = _hits(scenes, rays)
    hit = th.hit.numpy()
    jsi = jshading.get_shading_data_fast(js, jh, jray)
    tsi = shading.get_shading_data(ts, th, tray)  # rows None: the gathers
    for f in ("position", "normal", "emission", "diffuse_albedo",
              "fresnel_0", "albedo"):
        np.testing.assert_allclose(
            getattr(tsi, f).to_array().numpy()[hit],
            np.asarray(getattr(jsi, f).to_array())[hit], rtol=EPI_RTOL,
            atol=EPI_ATOL, err_msg=f)
    for f in ("roughness", "transmission", "ior", "lambert_out"):
        np.testing.assert_allclose(getattr(tsi, f).numpy()[hit],
                                   np.asarray(getattr(jsi, f))[hit],
                                   rtol=EPI_RTOL, atol=EPI_ATOL, err_msg=f)
    jpl = jlights.light_pdf_of_hit(jlights.build_light_table(js), js,
                                   jh.inst, jh.tri, jray.d, jh.t)
    tpl = lights.light_pdf_of_hit(tp.lights, ts, th.inst, th.tri, tray.d,
                                  th.t)
    assert (np.asarray(jpl) > 0).sum() >= 10  # rays that hit the light
    np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), rtol=EPI_RTOL)


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
@pytest.mark.parametrize("regen", [True, False], ids=["regen", "standard"])
def test_render_matches_jax(scenes, regen, nee):
    """render_radiance at 16x12, 3 bounces, frame 2, against JAX's
    (its superchunk kernels in interpret mode)."""
    js, ts, _, _ = scenes
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref = jax_render_radiance(
            js, jax_grid_camera(W, H, n=N_GRID),
            JRenderConfig(bounces=3, traversal=JTraversal.PALLAS, nee=nee,
                          regen=regen), 2)
    finally:
        jip._FORCE_INTERPRET = old
    got = render_radiance(ts, grid_camera(W, H, n=N_GRID),
                          RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                                       nee=nee, regen=regen), 2)
    ok = (np.abs(got.radiance.numpy() - np.asarray(ref.radiance))
          <= FRAME_ATOL).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], rtol=1e-5)
    assert got.segments.numpy().sum() >= W * H


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_ray_sort_is_transparent(scenes, nee):
    """The standard loop's per-bounce sort (tests/test_intersect.py
    ``test_octant_sort_is_transparent``) changes no bit of the frame."""
    ts = scenes[1]
    cam = grid_camera(24, 16, n=N_GRID)
    cfg = RenderConfig(bounces=3, traversal=Traversal.PALLAS, nee=nee,
                       regen=False)
    a = render_radiance(ts, cam, cfg.replace(sort_rays=True), 1)
    b = render_radiance(ts, cam, cfg.replace(sort_rays=False), 1)
    for k in AOVS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_regen_bit_equal_to_standard_loop(scenes, nee):
    ts = scenes[1]
    cam = grid_camera(24, 16, n=N_GRID)
    cfg = RenderConfig(bounces=3, traversal=Traversal.PALLAS, nee=nee)
    a = render_radiance(ts, cam, cfg, 1)  # regen=None: regen
    b = render_radiance(ts, cam, cfg.replace(regen=False), 1)
    for k in AOVS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_rows_kernel_dispatch(scenes, monkeypatch):
    """``_SC_LITE`` False, or triangle rows over ``_SC_RESIDENT_BYTES``,
    take kernel 6 (HitInfo with rows), as the reference dispatches; the
    winners equal the lite path's."""
    _, ts, _, tp = scenes
    cam = grid_camera(W, H, n=N_GRID)
    pids = torch.arange(W * H)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % W, pids // W, 0),
                               RenderConfig())
    lite = ti.trace_pallas(ts, ray, None, tp)
    assert lite.rows is None
    monkeypatch.setattr(ti, "_SC_RESIDENT_BYTES", tp.m3_bytes - 1)
    rows = ti.trace_pallas(ts, ray, None, tp)
    assert rows.rows is not None and rows.rows.shape == (ti.OUT_R, W * H)
    for f in ("t", "eidx", "tri", "inst", "steps"):
        assert torch.equal(getattr(lite, f), getattr(rows, f)), f
    hit = lite.hit
    np.testing.assert_allclose(lite.u[hit].numpy(), rows.u[hit].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(lite.v[hit].numpy(), rows.v[hit].numpy(),
                               atol=1e-4)
    with pytest.raises(ValueError, match="flat scenes"):
        ti.trace_occlude_pallas(ts, ray, None, ray, lite.t, lite.hit, tp)


@pytest.mark.parametrize("bad", ["scc", "sc_bounds", "ragged", "device",
                                 "group_bounds"])
def test_two_level_kernels_reject_bad_inputs(scenes, rays, bad):
    tp = scenes[3]
    o4, d4 = (torch.from_numpy(x) for x in rays)
    args = [o4, d4, tp.sc_bounds, tp.chunk_bounds, tp.group_bounds,
            tp.mu_pad, tp.mv_pad, tp.mw_pad]
    scc = tp.scc
    if bad == "scc":
        scc = 3  # does not divide the 40 chunks
    elif bad == "sc_bounds":
        args[2] = args[2][:, :4].contiguous()
    elif bad == "ragged":
        args[0], args[1] = args[0][:, :200].contiguous(), \
            args[1][:, :200].contiguous()
    elif bad == "group_bounds":  # a box a chunk, not a box a group
        args[4] = tp.chunk_bounds
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        ti.closest_hit_sc_lite(*args, scc)
    if bad != "group_bounds":  # kernel 6 takes no group boxes
        with pytest.raises((TypeError, ValueError)):
            ti.closest_hit_rows_sc(*args[:4], *args[5:],
                                   tp.tab.to(args[0].device), scc)
