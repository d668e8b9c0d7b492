"""Kernel 1 of the port (ops/intersect.py closest_hit_rows) against the JAX
rows kernel run in Pallas interpret mode, on the demo scene.

Rays: primary rays of a 32x16 demo camera plus 256 random rays from inside
the room (768 rays, three 256-ray blocks). Inputs are made with numpy from a
fixed seed and handed to both frameworks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import build_demo_scene as jax_demo_scene

from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera
from gdpathtracing_torch.config import Jitter, RenderConfig
from gdpathtracing_torch.core import rng

torch.set_num_threads(1)

# t: rtol 1e-6 — XLA's K=4 dot and the port's elementwise sum round
# differently (~1 ulp on each of u, v, w, hence t). Short hits (t << 1)
# get atol 1e-6 on top: there t = -w_o/w_d inherits one ulp of the O(1)
# dot terms as an absolute, not a relative, error.
T_RTOL, T_ATOL = 1e-6, 1e-6
# eidx: at most 0.5% of rays may pick the other triangle of a shared edge
# (a grazing tie decided by that last ulp); t must still agree there.
MAX_EIDX_MISMATCH = 0.005
# u/v/w_d of the same winner: the same ~1-ulp rounding, on values <= ~1e2.
UVW_ATOL = 1e-5
# rows 0-39 of the same winner: the JAX kernel merges a new winner as
# old + (new - old) * 1, which rounds when a ray's winner changes twice,
# and XLA builds the light rows 30-33 (pick term, unit normal) with another
# summation order and FMA contraction: ~1 ulp, on values of magnitude <= 1
# for the normals.
ROWS_RTOL, ROWS_ATOL = 1e-6, 2e-7


@pytest.fixture(scope="module")
def scenes():
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          device="cpu")
    return js, ts


def _rays(n_random=256, seed=0):
    """(ox, oy, oz, dx, dy, dz) float32 numpy arrays."""
    cam = demo_camera(32, 16)
    pids = torch.arange(32 * 16)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % 32, pids // 32, 7),
                               RenderConfig(jitter=Jitter.UNIFORM))
    g = np.random.default_rng(seed)
    o = g.uniform(-2.5, 2.5, (n_random, 3)).astype(np.float32)
    d = g.normal(size=(n_random, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cols = [np.concatenate([getattr(ray.o, k).numpy(), o[:, i]])
            for i, k in enumerate("xyz")]
    cols += [np.concatenate([getattr(ray.d, k).numpy(), d[:, i]])
             for i, k in enumerate("xyz")]
    return [c.astype(np.float32) for c in cols]


def _o4d4(cols):
    n = cols[0].shape[0]
    o4 = np.stack(cols[:3] + [np.ones(n, np.float32)])
    d4 = np.stack(cols[3:] + [np.zeros(n, np.float32)])
    return o4, d4


def _jax_rows(js, o4, d4):
    prep = jip.prepare_trace_inputs(js)
    return np.asarray(jip._closest_hit_rows(
        jnp.asarray(o4), jnp.asarray(d4), js.isect_chunk_bounds, prep.m3,
        prep.tab, interpret=True))


def _compare_hits(t_j, e_j, t_p, e_p):
    """Shared checks: t everywhere, eidx up to grazing ties. Returns the
    mask of rays whose winner agrees."""
    np.testing.assert_allclose(t_p, t_j, rtol=T_RTOL, atol=T_ATOL)
    same = e_j == e_p
    assert (~same).mean() <= MAX_EIDX_MISMATCH, (~same).sum()
    # Every disagreement is a tie: both hit, at the same t.
    assert (t_j[~same] < MISS_T).all() and (t_p[~same] < MISS_T).all()
    return same


def test_trace_table_matches_jax(scenes):
    js, ts = scenes
    tab_j = np.asarray(jip.build_trace_table(js))
    tab_p = ti.build_trace_table(ts).numpy()
    assert tab_p.shape == tab_j.shape == (ti.TAB_R, 2048)
    np.testing.assert_allclose(tab_p, tab_j, rtol=ROWS_RTOL, atol=ROWS_ATOL)
    # Everything but the light rows is bit-equal.
    rest = np.r_[0:30, 34:40]
    np.testing.assert_array_equal(tab_p[rest], tab_j[rest])


def test_inflated_bounds_match_jax(scenes):
    js, ts = scenes
    np.testing.assert_array_equal(
        ti._inflate_bounds(ts.isect_chunk_bounds).numpy(),
        np.asarray(jip._inflate_bounds(js.isect_chunk_bounds)))


def test_closest_hit_rows_plain_matches_jax(scenes):
    js, ts = scenes
    o4, d4 = _o4d4(_rays())
    rows_j = _jax_rows(js, o4, d4)
    prep = ti.prepare_trace_inputs(ts)
    rows_p = ti.closest_hit_rows(torch.from_numpy(o4), torch.from_numpy(d4),
                                 prep.bounds, prep.mu, prep.mv, prep.mw,
                                 prep.tab).numpy()
    assert rows_p.shape == rows_j.shape == (ti.OUT_R, o4.shape[1])
    hit = rows_j[40] < MISS_T
    assert hit.sum() > 200  # the room's open front lets the rest escape
    same = _compare_hits(rows_j[40], rows_j[44], rows_p[40], rows_p[44])
    np.testing.assert_allclose(rows_p[:ti.TAB_R, same],
                               rows_j[:ti.TAB_R, same], rtol=ROWS_RTOL,
                               atol=ROWS_ATOL)
    np.testing.assert_allclose(rows_p[41:44, same], rows_j[41:44, same],
                               atol=UVW_ATOL)
    # Row 45 counts 256 triangles per chunk the ray's own slab test passed
    # (visit-order dependent, so not compared exactly with JAX).
    steps = rows_p[45]
    assert (steps % ti.BT == 0).all() and (steps <= 2048).all()
    assert (steps[hit] >= ti.BT).all()
    assert (rows_p[47] == 0).all()


def test_trace_pallas_hitinfo_matches_jax(scenes):
    js, ts = scenes
    cols = _rays(n_random=100, seed=1)  # 612 rays: exercises the padding
    n = cols[0].shape[0]
    active = np.random.default_rng(2).uniform(size=n) < 0.8
    jh = jip.trace_pallas(
        js, JRay(JVec3(*map(jnp.asarray, cols[:3])),
                 JVec3(*map(jnp.asarray, cols[3:]))),
        jnp.asarray(active), interpret=True)
    th = ti.trace_pallas(
        ts, Ray(Vec3(*map(torch.from_numpy, cols[:3])),
                Vec3(*map(torch.from_numpy, cols[3:]))),
        torch.from_numpy(active))
    t_j, t_p = np.asarray(jh.t), th.t.numpy()
    same = _compare_hits(t_j, np.asarray(jh.eidx), t_p, th.eidx.numpy())
    assert (t_p[~active] == MISS_T).all()
    for f in ("tri", "inst", "front"):
        np.testing.assert_array_equal(getattr(th, f).numpy()[same],
                                      np.asarray(getattr(jh, f))[same])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy()[same],
                                   np.asarray(getattr(jh, f))[same],
                                   atol=UVW_ATOL)
    assert th.rows.shape == (ti.OUT_R, n)
    assert th.tri.dtype == th.inst.dtype == th.eidx.dtype == torch.int32


def _prep_inputs(ts, n=256):
    o4, d4 = _o4d4(_rays(n_random=n)[:6])
    prep = ti.prepare_trace_inputs(ts)
    return [torch.from_numpy(o4[:, :n]).contiguous(),
            torch.from_numpy(d4[:, :n]).contiguous(),
            prep.bounds, prep.mu, prep.mv, prep.mw, prep.tab]


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "ragged",
                                 "device"])
def test_closest_hit_rows_rejects_bad_inputs(scenes, bad):
    args = _prep_inputs(scenes[1])
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "layout":
        args[6] = args[6].T.contiguous().T
    elif bad == "shape":
        args[2] = args[2][:, :4].contiguous()
    elif bad == "ragged":
        args[0], args[1] = args[0][:, :200].contiguous(), \
            args[1][:, :200].contiguous()
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        ti.closest_hit_rows(*args)


def test_cpu_tensors_take_the_plain_version(scenes):
    args = _prep_inputs(scenes[1])
    before = ti.closest_hit_rows.launches
    out = ti.closest_hit_rows(*args)
    assert ti.closest_hit_rows.launches == before  # no kernel launched
    assert torch.equal(out, ti.closest_hit_rows_plain(*args))

